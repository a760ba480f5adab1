"""The port's online (streaming) SLAM mode against the JAX package's.

Shapes follow tests/test_online.py: N = 30 steps of R = 120 rays, K = 200
slots, n_max 64. Both packages get the same numpy inputs (scan points
included), JAX runs on the CPU, and the port runs on CPU tensors (the
kernels' plain versions). Tolerances: poses and relative poses 2e-4 (the
online-vs-offline bound of tests/test_online.py:47), match_rms 1e-5, maps
1e-4 against JAX (its CPU map adds in ray-LENGTH order) and bit-exact
against the port's own batch build (both in ray order), refine 2e-5 (the
LM bound of tests/test_torch_pose_graph.py).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lidar_slam_tpu.config as jc
from lidar_slam_tpu.models import odometry as jodo
from lidar_slam_tpu.models import online as jon
from lidar_slam_tpu.ops import scan as jscan
from lidar_slam_tpu.utils import io as jio
from lidar_slam_tpu.utils import png as jpng

import lidar_slam_tpu_torch.config as tc
from lidar_slam_tpu_torch.kernels.nn import nn_argmin
from lidar_slam_tpu_torch.kernels.raywalk import raywalk_scan
from lidar_slam_tpu_torch.models import occupancy as tocc
from lidar_slam_tpu_torch.models import odometry as todo
from lidar_slam_tpu_torch.models import online as ton
from lidar_slam_tpu_torch.online_slam import main as cli_main
from lidar_slam_tpu_torch.ops import scan as tscan
from lidar_slam_tpu_torch.utils import export as texport
from lidar_slam_tpu_torch.utils import interop
from lidar_slam_tpu_torch.utils import png as tpng

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG, TCFG = jc.SlamConfig(), tc.SlamConfig()
N, R, K = 30, 120, 200
POSE_TOL, RMS_TOL, MAP_TOL, REFINE_TOL = 2e-4, 1e-5, 1e-4, 2e-5


def _log(seed, n=N, n_rays=R):
    """(counts, gyro, points, masks) numpy arrays of one synthetic log."""
    d = jio.synthetic_dataset(n_steps=n, n_rays=n_rays, seed=seed)
    counts = np.asarray(d["encoder"]["counts"], np.float32)
    gyro = np.asarray(d["imu"]["angular_velocity"], np.float32)
    pts, masks = jscan.scans_to_points(
        jnp.asarray(d["lidar"]["ranges"], jnp.float32), 0.1, 30.0,
        JCFG.lidar)
    return counts, gyro, np.array(pts, np.float32), np.array(masks)


def _jax_run(log, steps=N, n_max=64, cfg=JCFG, x0=None, st=None, start=1,
             k=K):
    counts, gyro, pts, masks = log
    if st is None:
        st = jon.init_state(jnp.asarray(pts[0]), jnp.asarray(masks[0]), cfg,
                            n_max=n_max, K=k,
                            x0=None if x0 is None else jnp.asarray(x0))
    for t in range(start, steps):
        st = jon.online_step(st, jnp.asarray(counts[t]), jnp.asarray(gyro[t]),
                             jnp.asarray(pts[t]), jnp.asarray(masks[t]), cfg,
                             K=k)
    return st


def _port_run(log, steps=N, n_max=64, cfg=TCFG, x0=None, st=None, start=1,
              k=K):
    counts, gyro, pts, masks = log
    if st is None:
        st = ton.init_state(pts[0], masks[0], cfg, n_max=n_max, K=k, x0=x0,
                            device="cpu")
    for t in range(start, steps):
        st = ton.online_step(st, counts[t], gyro[t], pts[t], masks[t], cfg,
                             K=k)
    return st


def _np(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def test_diff_drive_motion_model_matches_jax():
    rng = np.random.default_rng(0)
    pose = rng.normal(0, 2, (6, 3)).astype(np.float32)
    v = rng.normal(0, 1, 6).astype(np.float32)
    w = rng.normal(0, 1, (6, 3)).astype(np.float32)
    w[0, 2] = 0.0  # the series branch of sinc
    want = np.asarray(jodo.diff_drive_motion_model(
        jnp.asarray(pose), jnp.asarray(v), jnp.asarray(w), 0.025))
    got = todo.diff_drive_motion_model(*map(torch.from_numpy, (pose, v, w)),
                                       0.025)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_online_track_matches_jax():
    log = _log(0)
    launches = (nn_argmin.launches, raywalk_scan.launches)
    tst = _port_run(log)
    assert (nn_argmin.launches, raywalk_scan.launches) == launches
    t, j = _np(tst), _np(_jax_run(log))
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
    assert int(t["step"]) == N - 1
    np.testing.assert_allclose(t["poses_hist"][:N], j["poses_hist"][:N],
                               rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(t["rel_hist"][1:N], j["rel_hist"][1:N],
                               rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(t["pose"], j["pose"], rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(t["match_rms"], j["match_rms"], rtol=0,
                               atol=RMS_TOL)
    assert 0 < float(t["match_rms"]) < 0.05


def test_online_causal_map():
    """Bit-exact against the port's own batch build over the stream's own
    track (both add in ray order), 1e-4 against the JAX stream's map."""
    log = _log(1)
    st = _port_run(log)
    pts, masks = (torch.from_numpy(a) for a in log[2:])
    want = tocc.build_logodds(st.poses_hist[:N], pts, masks, TCFG.map, K)
    assert torch.equal(st.logodds, want)
    assert int((want != 0).sum()) > 200
    np.testing.assert_allclose(st.logodds.numpy(),
                               np.asarray(_jax_run(log).logodds), rtol=0,
                               atol=MAP_TOL)


def test_tracking_loss_gate_matches_jax():
    """A finite loss_rms_thresh and scan 15 swapped for a scan from far
    along the log: the same steps coast in both packages, neither paints
    the map on them, and the poses agree."""
    counts, gyro, pts, masks = _log(8, n=240)
    pts, masks = pts.copy(), masks.copy()
    pts[15], masks[15] = pts[230], masks[230]
    log = (counts, gyro, pts, masks)
    jcfg = dataclasses.replace(JCFG, online=jc.OnlineConfig(
        loss_rms_thresh=0.3))
    tcfg = dataclasses.replace(TCFG, online=tc.OnlineConfig(
        loss_rms_thresh=0.3))
    jst = _jax_run(log, steps=1, cfg=jcfg)
    tst = _port_run(log, steps=1, cfg=tcfg)
    lost = {"jax": [], "port": []}
    for t in range(1, N):
        j_before, t_before = np.asarray(jst.logodds), tst.logodds.clone()
        jst = _jax_run(log, steps=t + 1, cfg=jcfg, st=jst, start=t)
        tst = _port_run(log, steps=t + 1, cfg=tcfg, st=tst, start=t)
        for name, rms, same in (
                ("jax", jst.match_rms,
                 np.array_equal(j_before, np.asarray(jst.logodds))),
                ("port", tst.match_rms, torch.equal(t_before, tst.logodds))):
            is_lost = float(rms) > 0.3
            assert same == is_lost, (name, t)
            if is_lost:
                lost[name].append(t)
        np.testing.assert_allclose(tst.pose.numpy(), np.asarray(jst.pose),
                                   rtol=0, atol=POSE_TOL)
    assert lost["port"] == lost["jax"] and 15 in lost["port"]
    np.testing.assert_allclose(tst.poses_hist.numpy()[:N],
                               np.asarray(jst.poses_hist)[:N], rtol=0,
                               atol=POSE_TOL)


# refine cases of tests/test_online.py:69-153: between factors only, gated
# fixed-interval loops, past capacity (n_max 8: window below the loop
# interval; n_max 24: loops inside the window) and a start pose x0 != 0
REFINE_CASES = {
    "between": dict(seed=2, steps=N, n_max=64, x0=None, scans=False),
    "loops_x0": dict(seed=4, steps=N, n_max=64, x0=(5.0, -2.0, 0.3),
                     scans=True),
    "past_capacity_8": dict(seed=3, steps=20, n_max=8, x0=None, scans=True),
    "past_capacity_8_between": dict(seed=3, steps=20, n_max=8, x0=None,
                                    scans=False),
    "past_capacity_24_loops": dict(seed=6, steps=N, n_max=24, x0=None,
                                   scans=True),
}


@pytest.mark.parametrize("case", sorted(REFINE_CASES))
def test_refine_matches_jax(case, tmp_path):
    """The JAX stream's state carried into the port through save_state ->
    load_state; both packages' refine on it agree within 2e-5."""
    c = REFINE_CASES[case]
    log = _log(c["seed"], n=c["steps"])
    jst = _jax_run(log, steps=c["steps"], n_max=c["n_max"], x0=c["x0"])
    path = str(tmp_path / "jax.npz")
    jon.save_state(path, jst)
    tst = ton.load_state(path, device="cpu")
    kw = {}
    if c["scans"]:
        kw = dict(scans=log[2], scan_masks=log[3])
    want = jon.refine(jst, JCFG, **kw)
    got = ton.refine(tst, TCFG, **kw)
    n = min(c["steps"], c["n_max"])
    assert got.shape == want.shape == (n, 3) and got.dtype == want.dtype
    assert ton.window_start(tst) == jon.window_start(jst) == c["steps"] - n
    np.testing.assert_allclose(got, want, rtol=0, atol=REFINE_TOL)
    assert np.abs(got - tst.poses_hist.numpy()[
        (c["steps"] - n + np.arange(n)) % c["n_max"]]).max() < 0.5
    if c["x0"] is not None:
        np.testing.assert_allclose(got[0], c["x0"], atol=0.05)


def test_refine_input_checks_match_jax():
    log = _log(7)
    jst = _jax_run(log)
    tst = ton.OnlineState(**interop.from_numpy(_np(jst)))
    pts, masks = log[2], log[3]
    for kw in (dict(scans=pts), dict(scans=pts[:5], scan_masks=masks[:5]),
               dict(scans=pts, scan_masks=masks[:5])):
        with pytest.raises(ValueError) as je:
            jon.refine(jst, JCFG, **kw)
        with pytest.raises(ValueError) as te:
            ton.refine(tst, TCFG, **kw)
        assert str(te.value) == str(je.value)
    # a revisit proposer without scans: between factors only, as JAX's
    desc_j, desc_t = (dataclasses.replace(C, pose_graph=dataclasses.replace(
        C.pose_graph, loop_proposer="descriptor")) for C in (JCFG, TCFG))
    np.testing.assert_allclose(ton.refine(tst, desc_t),
                               jon.refine(jst, desc_j), rtol=0,
                               atol=REFINE_TOL)


def test_checkpoint_resumes_across_packages(tmp_path):
    """Port checkpoint -> port: the resumed run equals the uninterrupted
    one bit for bit. Port checkpoint -> JAX and JAX checkpoint -> port:
    the continuations agree with the other package's within 2e-4."""
    log = _log(5)
    p_ck, j_ck = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tst = _port_run(log, steps=15)
    ton.save_state(p_ck, tst)
    full = _np(_port_run(log, st=tst, start=15))
    resumed = _np(_port_run(log, st=ton.load_state(p_ck, device="cpu"),
                            start=15))
    for k in full:
        np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)

    jst = _jax_run(log, steps=15)
    jon.save_state(j_ck, jst)
    with np.load(p_ck) as a, np.load(j_ck) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
    j_full = _np(_jax_run(log, st=jst, start=15))
    j_from_port = _np(_jax_run(log, st=jon.load_state(p_ck), start=15))
    t_from_jax = _np(_port_run(log, st=ton.load_state(j_ck, device="cpu"),
                            start=15))
    for got, want in ((j_from_port, full), (t_from_jax, j_full)):
        np.testing.assert_allclose(got["poses_hist"][:N],
                                   want["poses_hist"][:N], rtol=0,
                                   atol=POSE_TOL)
        np.testing.assert_allclose(got["logodds"], want["logodds"], rtol=0,
                                   atol=MAP_TOL)
        assert int(got["step"]) == N - 1


def test_cli_matches_jax_stream(tmp_path):
    """python -m lidar_slam_tpu_torch.online_slam in a subprocess: its
    track equals the port's in-process stream bit for bit and the JAX
    package's online_step stream within 2e-4 (the JAX CLI's own tests are
    marked slow); then --resume of its checkpoint.

    A --synthetic log has 1,081 rays, where float32 NN near-ties are
    common and the two packages round the cross term differently (ROADMAP
    Queue 3): on this log they first move an ICP stop by one iteration at
    step 32 (2.5e-3), so the stream is 30 steps, with the window cut to 16
    so the step-20 refine runs past capacity."""
    ck, poses, png = (str(tmp_path / f) for f in ("ck.npz", "track.npy",
                                                  "map.png"))
    cmd = [sys.executable, "-m", "lidar_slam_tpu_torch.online_slam",
           "--synthetic", "30", "--res", "0.2", "--width", "16",
           "--height", "16", "--window", "16", "--refine_every", "10",
           "--refine_loops", "fixed", "--checkpoint", ck, "--poses_path",
           poses, "--map_path", png, "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step 20: refined window of 16 poses (start step 5)" in out.stderr

    # the same stream in process, from the CLI's own scan points
    d = jio.synthetic_dataset(n_steps=30, seed=0)
    rmax = float(d["lidar"]["range_max"])
    pts, masks = tscan.scans_to_points(
        torch.as_tensor(d["lidar"]["ranges"], dtype=torch.float32),
        float(d["lidar"]["range_min"]), rmax, TCFG.lidar)
    log = (np.asarray(d["encoder"]["counts"], np.float32),
           np.asarray(d["imu"]["angular_velocity"], np.float32),
           pts.numpy(), masks.numpy())
    jcfg = jc.SlamConfig(map=jc.MapConfig.from_cli(0.2, 16, 16))
    tcfg = tc.SlamConfig(map=tc.MapConfig.from_cli(0.2, 16, 16))
    k = jon.default_ray_cells(jcfg, rmax)
    jst = _jax_run(log, steps=1, n_max=16, cfg=jcfg, k=k)
    tst = _port_run(log, steps=1, n_max=16, cfg=tcfg, k=k)
    want_j, want_t = [np.asarray(jst.pose)], [tst.pose.numpy()]
    for t in range(1, 30):
        jst = _jax_run(log, steps=t + 1, cfg=jcfg, st=jst, start=t, k=k)
        tst = _port_run(log, steps=t + 1, cfg=tcfg, st=tst, start=t, k=k)
        want_j.append(np.asarray(jst.pose))
        want_t.append(tst.pose.numpy())
    track = np.load(poses)
    assert track.shape == (30, 3) and track.dtype == np.float32
    np.testing.assert_array_equal(track, np.stack(want_t))
    np.testing.assert_allclose(track, np.stack(want_j), rtol=0,
                               atol=POSE_TOL)
    img = tpng.read_png(png)
    assert img.shape == (81, 81) and img.dtype == np.uint8
    with np.load(ck) as z:
        np.testing.assert_array_equal(z["logodds"], tst.logodds.numpy())
        np.testing.assert_array_equal(img, tocc.render_logodds(z["logodds"]))
        assert int(z["step"]) == 29

    out = subprocess.run(cmd + ["--resume"], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"resumed from {ck} at step 29" in out.stderr
    assert "stream exhausted" in out.stderr


@pytest.mark.parametrize("flags", [
    ["--localize", "map.npy"], ["--global_init"], ["--relocalize_on_loss"]])
def test_cli_refuses_unported_flags(flags, capsys):
    with pytest.raises(SystemExit) as e:
        cli_main(["--synthetic", "10", "--device", "cpu"] + flags)
    assert e.value.code != 0
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--export_ros_map", "stem"], ["--refine_loops", "proximity"],
    ["--refine_loops", "descriptor"], ["--robust_loss", "huber"],
    ["--robust_loss", "cauchy"], ["--icp_metric", "point_to_line"]])
def test_cli_runs_lifted_flags(flags, tmp_path, monkeypatch):
    """Each flag the online CLI refused until the revisit slice now runs a
    12-step stream (refining every 10 steps with the window's scans) and
    takes effect: the config online_step and refine receive (refine gets
    the stream's range span for the descriptor), or the ROS map of the
    final causal map; with --export_ros_map the files equal the JAX
    online CLI's byte for byte."""
    monkeypatch.chdir(tmp_path)
    seen = {"step": [], "refine": []}
    real_step, real_refine = ton.online_step, ton.refine

    def step(*a, **kw):
        seen["step"].append(a[5])
        return real_step(*a, **kw)

    def refine(st, cfg, **kw):
        seen["refine"].append((cfg, kw))
        return real_refine(st, cfg, **kw)

    monkeypatch.setattr(ton, "online_step", step)
    monkeypatch.setattr(ton, "refine", refine)
    base = ["--synthetic", "12", "--res", "0.2", "--width", "16",
            "--height", "16", "--refine_every", "10", "--checkpoint",
            "ck.npz", "--map_path", "m.png"]
    if flags[0] != "--refine_loops":
        base += ["--refine_loops", "fixed"]
    assert cli_main(base + flags + ["--device", "cpu"]) == 0
    assert len(seen["step"]) == 11 and len(seen["refine"]) == 1
    cfg, kw = seen["refine"][0]
    assert kw["scans"].shape[0] == 11
    if flags[0] == "--export_ros_map":
        with np.load("ck.npz") as z:
            lo = z["logodds"]
        texport.save_map_ros(lo, cfg.map, "want")
        assert (open("stem.pgm", "rb").read()
                == open("want.pgm", "rb").read())
        import online_slam as jax_online

        jax_online.main(base + ["--export_ros_map", "jstem"])
        assert (open("stem.pgm", "rb").read()
                == open("jstem.pgm", "rb").read())
        assert (open("stem.yaml").read().replace("stem.pgm", "jstem.pgm")
                == open("jstem.yaml").read())
    elif flags[0] == "--refine_loops":
        assert cfg.pose_graph.loop_proposer == flags[1]
        assert kw["descriptor_range"] == (0.1, 30.0)
    elif flags[0] == "--robust_loss":
        assert cfg.pose_graph.robust_loss == flags[1]
    else:
        assert all(c.icp.metric == "point_to_line" for c in seen["step"])


@pytest.mark.parametrize("argv,msg", [
    (["--resume"], "--resume requires --checkpoint"),
    (["--resume", "--checkpoint", "missing.npz"],
     "--resume: checkpoint 'missing.npz' does not exist"),
    (["--window", "0"], "--window must be positive, got 0"),
])
def test_cli_validation_messages(argv, msg, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli_main(["--synthetic", "5", "--device", "cpu"] + argv)
    assert str(e.value.code).startswith(msg)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-CUDA refusal is not "
                    "reachable")
    log = _log(0, n=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ton.init_state(log[2][0], log[3][0], TCFG, K=K, device="cuda")
    out = subprocess.run(
        [sys.executable, "-m", "lidar_slam_tpu_torch.online_slam",
         "--synthetic", "5", "--device", "cuda"], capture_output=True,
        text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_write_png_bytes_equal_jax(kind, tmp_path):
    rng = np.random.default_rng(1)
    img = {"gray8": rng.integers(0, 256, (17, 23), dtype=np.uint8),
           "rgb8": rng.integers(0, 256, (9, 14, 3), dtype=np.uint8),
           "gray16": rng.integers(0, 65536, (11, 6), dtype=np.uint16)}[kind]
    jpng.write_png(str(tmp_path / "j.png"), img)
    tpng.write_png(str(tmp_path / "t.png"), img)
    data = (tmp_path / "t.png").read_bytes()
    assert data == (tmp_path / "j.png").read_bytes()
    back = tpng.read_png(str(tmp_path / "t.png"))
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)
