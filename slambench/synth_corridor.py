"""Seeded synthetic logs of a drive around a loop of corridors, at the
shapes of the UCSD ECE 276A PR2 datasets: one synchronized step per
encoder sample at 40 Hz, each with 4 encoder counts, a gyro and a Hokuyo
scan of n_rays beams over 270 degrees.

Why a corridor. The reference's filter (main.py --filter_lidar) keeps a
point only if at least 10 returns lie within 0.1 m of it (or of a point
that has them). At 0.25-degree beams a wall has that density only within
about 4.6 m at normal incidence, so the filter suits a building's
corridors and empties the open room of synth.py. Here the walls lie 0.8
to 1.6 m from the robot.

The geometry: a rectangular loop of corridors `width` wide around a
`loop_x` x `loop_y` centre line (centred on x = 0, from y = 0 to loop_y),
the outer and inner walls `width` / 2 off it; door recesses `door_width`
wide and `door_depth` deep every `door_every` metres on both walls of each
corridor (centred on each wall's middle, none within 0.3 m of a corner).
They constrain ICP along a corridor, where bare walls do not.

The drive: the robot follows the centre line (corners rounded to a 1 m
radius) counter-clockwise from the origin, heading +x, at speed +/-
speed_amp m/s (a 40 s period), weaving on the straights up to `weave`
metres to either side of it (`drive`), heading along its path. The trajectory and
the building do not depend on the seed; the seed draws the encoder, gyro
and range noise and the ~2% dropouts (as synth.synthetic_dataset: 0.05
ticks, 2e-3 rad/s, 3 mm, returned at 1.5 x range_max), so every seed
gives the same work. Rays start at the sensor, p_rl forward of the body.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

LIDAR_OFFSET = 0.13323  # LidarConfig.p_rl[0]
CORNER_RADIUS = 1.0
WEAVE_PERIOD = 8.0  # metres, the weave's period on a long straight
DOOR_MARGIN = 0.3


def corridor_dataset(
    n_steps: int = 4956,
    n_rays: int = 1081,
    seed: int = 0,
    range_min: float = 0.1,
    range_max: float = 30.0,
    speed: float = 0.30,
    speed_amp: float = 0.12,
    width: float = 2.4,
    loop_x: float = 10.0,
    loop_y: float = 6.0,
    door_width: float = 0.9,
    door_depth: float = 0.25,
    door_every: float = 3.0,
    weave: float = 0.4,
    n_rgb: int = 200,
) -> Dict:
    """A log in synth.synthetic_dataset's layout (encoder, lidar, imu,
    rgbd stamps, ground_truth), float64."""
    rng = np.random.default_rng(seed)
    freq = 40.0
    dt = 1.0 / freq
    t0 = 1e9
    stamps = t0 + np.arange(n_steps) * dt
    t = np.arange(n_steps) * dt
    s = np.cumsum((speed + speed_amp * np.sin(2 * np.pi * t / 40.0)) * dt)
    gt = drive(s, loop_x, loop_y, weave)

    step = np.diff(gt[:, :2], axis=0, prepend=gt[:1, :2])
    v = np.hypot(step[:, 0], step[:, 1]) / dt
    w = np.diff(np.unwrap(gt[:, 2]), prepend=gt[0, 2]) / dt
    v[0], w[0] = v[1], w[1]
    counts = np.repeat((v / (0.0022 * freq))[:, None], 4, axis=1)
    counts += rng.normal(0, 0.05, counts.shape)
    gyro = np.zeros((n_steps, 3))
    gyro[:, 2] = w + rng.normal(0, 2e-3, n_steps)
    acc = np.zeros((n_steps, 3))
    acc[:, 2] = 9.81

    angles = np.linspace(np.radians(-135.0), np.radians(135.0), n_rays)
    walls = building(width, loop_x, loop_y, door_width, door_depth,
                     door_every)
    ranges = raycast(gt, angles, walls).astype(np.float32)
    ranges = np.clip(ranges + rng.normal(0, 0.003, ranges.shape), 0.0,
                     range_max + 5.0)
    drop = rng.random(ranges.shape) < 0.02
    ranges = np.where(drop, range_max * 1.5, np.minimum(ranges,
                                                        range_max * 1.2))

    return {
        "encoder": {"counts": counts, "stamps": stamps},
        "lidar": {
            "angle_min": np.radians(-135.0),
            "angle_max": np.radians(135.0),
            "angle_increment": np.radians(270.0) / (n_rays - 1),
            "range_min": np.float64(range_min),
            "range_max": np.float64(range_max),
            "ranges": ranges,
            "stamps": stamps + rng.normal(0, 1e-4, n_steps),
        },
        "imu": {
            "angular_velocity": gyro,
            "linear_acceleration": acc,
            "stamps": stamps + rng.normal(0, 1e-4, n_steps),
        },
        "rgbd": {"disp_stamps": t0 + np.linspace(0, n_steps * dt,
                                                 int(n_rgb * 1.2)),
                 "rgb_stamps": t0 + np.linspace(0, n_steps * dt, n_rgb)},
        "ground_truth": gt,
    }


def drive(s: np.ndarray, loop_x: float, loop_y: float,
          weave: float) -> np.ndarray:
    """Poses (n, 3) at arc lengths s along the centre line: a loop_x x
    loop_y rectangle with corners rounded to CORNER_RADIUS, from the
    origin (the middle of its lower side) heading +x, counter-clockwise,
    lap after lap. On each straight of length L the robot weaves o(u) =
    weave sin(pi u / L) sin(2 pi m u / L) to the centre line's left, m =
    max(1, round(L / WEAVE_PERIOD)); o and o' vanish where a straight meets
    an arc, so the path has no kink. The heading is the path's tangent,
    (1 - o kappa) t + o' n with o = 0 on the arcs."""
    r = CORNER_RADIUS
    a, b = loop_x - 2 * r, loop_y - 2 * r
    # (length, start point, start heading, curvature) of each piece
    pieces, p, h = [], np.array([0.0, 0.0]), 0.0
    for length, kappa in ((a / 2, 0.0), (np.pi * r / 2, 1 / r),
                          (b, 0.0), (np.pi * r / 2, 1 / r),
                          (a, 0.0), (np.pi * r / 2, 1 / r),
                          (b, 0.0), (np.pi * r / 2, 1 / r),
                          (a / 2, 0.0)):
        pieces.append((length, p.copy(), h, kappa))
        if kappa:
            c = p + r * np.array([-np.sin(h), np.cos(h)])
            h += length * kappa
            p = c + r * np.array([np.sin(h), -np.cos(h)])
        else:
            p = p + length * np.array([np.cos(h), np.sin(h)])
    lap = sum(pc[0] for pc in pieces)
    u_lap = np.mod(s, lap)
    out = np.zeros((s.size, 3))
    start = 0.0
    for length, p0, h0, kappa in pieces:
        on = (u_lap >= start) & (u_lap < start + length)
        u = u_lap[on] - start
        start += length
        if kappa:
            c = p0 + r * np.array([-np.sin(h0), np.cos(h0)])
            hh = h0 + u * kappa
            out[on, :2] = c + r * np.stack([np.sin(hh), -np.cos(hh)], -1)
            out[on, 2] = hh
            continue
        m = max(1, round(length / WEAVE_PERIOD))
        q, qm = np.pi / length, 2 * np.pi * m / length
        o = weave * np.sin(q * u) * np.sin(qm * u)
        do = weave * (q * np.cos(q * u) * np.sin(qm * u)
                      + qm * np.sin(q * u) * np.cos(qm * u))
        t, n = np.array([np.cos(h0), np.sin(h0)]), np.array(
            [-np.sin(h0), np.cos(h0)])
        out[on, :2] = p0 + u[:, None] * t + o[:, None] * n
        out[on, 2] = h0 + np.arctan2(do, 1.0)
    out[:, 2] = np.unwrap(out[:, 2])
    return out


def building(width: float, loop_x: float, loop_y: float, door_width: float,
             door_depth: float, door_every: float) -> list:
    """The walls as (box, doors) for the outer and the inner rectangle:
    box (x0, x1, y0, y1); doors {face: centres along it}, faces 0-3 the
    walls at x0, x1, y0, y1; and the recess depth and half-width."""
    half = width / 2
    out = []
    for grow in (half, -half):
        box = (-loop_x / 2 - grow, loop_x / 2 + grow, -grow, loop_y + grow)
        doors = {}
        for face in range(4):
            lo, hi = (box[2], box[3]) if face < 2 else (box[0], box[1])
            mid, span = (lo + hi) / 2, (hi - lo) / 2
            k = np.arange(-int(span // door_every) - 1,
                          int(span // door_every) + 2)
            c = mid + door_every * k
            doors[face] = c[np.abs(c - mid) + door_width / 2
                            <= span - DOOR_MARGIN]
        out.append((box, doors))
    return [out, door_depth, door_width / 2]


def raycast(poses: np.ndarray, angles: np.ndarray, walls: list,
            chunk: int = 256) -> np.ndarray:
    """(N, R) distances from the sensor (p_rl forward of each pose) along
    each beam to the first wall, for a sensor inside the corridors.

    A beam leaves the ring of corridors through the outer rectangle or
    into the inner one, whichever it meets first; where that crossing lies
    in a door's opening, the beam ends on the recess's back or on the side
    it runs towards, whichever comes first (a recess is entered only
    through its opening)."""
    (outer, inner), depth, half_door = walls
    out = np.empty((poses.shape[0], angles.size))
    for s0 in range(0, poses.shape[0], chunk):
        p = poses[s0:s0 + chunk]
        th = p[:, 2:3] + angles[None, :]
        c, s = np.cos(th), np.sin(th)
        c = np.where(c == 0, 1e-300, c)
        s = np.where(s == 0, 1e-300, s)
        px = p[:, 0:1] + LIDAR_OFFSET * np.cos(p[:, 2:3])
        py = p[:, 1:2] + LIDAR_OFFSET * np.sin(p[:, 2:3])
        with np.errstate(divide="ignore", invalid="ignore"):
            # leaving the outer box: the nearer of its x and y walls ahead
            bx = outer[0]
            tx = np.where(c > 0, (bx[1] - px) / c, (bx[0] - px) / c)
            ty = np.where(s > 0, (bx[3] - py) / s, (bx[2] - py) / s)
            t_hit = np.minimum(tx, ty)
            face = np.where(tx <= ty, np.where(c > 0, 1, 0),
                            np.where(s > 0, 3, 2))
            # entering the inner box (slabs): the later of the entries
            bi = inner[0]
            ex = np.minimum((bi[0] - px) / c, (bi[1] - px) / c)
            fx = np.maximum((bi[0] - px) / c, (bi[1] - px) / c)
            ey = np.minimum((bi[2] - py) / s, (bi[3] - py) / s)
            fy = np.maximum((bi[2] - py) / s, (bi[3] - py) / s)
            t_in = np.maximum(ex, ey)
            hit_in = (t_in <= np.minimum(fx, fy)) & (t_in > 0) & (
                t_in < t_hit)
            face_in = np.where(ex >= ey, np.where(c > 0, 0, 1),
                               np.where(s > 0, 2, 3))
            t_hit = np.where(hit_in, t_in, t_hit)
            face = np.where(hit_in, 4 + face_in, face)
            hx, hy = px + t_hit * c, py + t_hit * s
            for k, (box, doors) in enumerate((outer, inner)):
                for f, centres in doors.items():
                    on = face == 4 * k + f
                    if not centres.size or not on.any():
                        continue
                    # along the wall (u) and into the recess (n, > 0)
                    u = hy[on] if f < 2 else hx[on]
                    du = s[on] if f < 2 else c[on]
                    dn = (c[on] if f < 2 else s[on]) * (
                        1 if (f % 2 == 1) == (k == 0) else -1)
                    near = centres[np.argmin(np.abs(u[:, None]
                                                    - centres[None, :]),
                                             axis=1)]
                    door = np.abs(u - near) <= half_door
                    side = near + np.where(du > 0, half_door, -half_door)
                    to_side = np.where(du != 0, (side - u) / du, np.inf)
                    deeper = np.minimum(depth / dn, to_side)
                    t_hit[on] += np.where(door, deeper, 0.0)
        out[s0:s0 + chunk] = t_hit
    return out
