"""The plain reference the benchmark holds the program to.

Plain PyTorch, written from the semantics of the UCSD ECE 276A PR2
project the program reimplements (scan conversion, differential-drive
odometry, point-to-point ICP with its stopping rules, the GTSAM-style pose
graph, the log-odds occupancy map with its Bresenham rays, and the particle
filter). It imports nothing of the program and nothing of JAX, and takes
nothing the program made: it works out points, masks, seeds, ray cells and
maps again from the inputs the benchmark made.

Every function runs in the dtype it is given. The benchmark runs it in
float64 as the reference; the control runs the same code in float32 with
TF32 matmuls on (`control.py`), the nearest precision below the float32
with TF32 off that the configurations state.
"""
