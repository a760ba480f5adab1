"""Set-up seconds: from the process's start to the first timed step (the
logs made, the kernels built or loaded, the warm-up run). Host clock."""


def read(run):
    return run.setup_s
