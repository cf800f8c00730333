"""SLAM odometry on the card: a drive through the yard (lib/yard.py),
`frames` frames ray-cast once a configuration and drawn from the seed,
replayed in passes, each with a fresh engine (a mapping user's run over a
recording):

    open_source(path) -> SlamEngine(backend="device").update(scans)

A scan counts once it is registered and its pose written back. The window
starts at the start of a pass.

The check follows the program from its own state, on a sample of scans
drawn from the seed. For each sampled scan the reference makes the frame's
ranges again from the seed and compares the decoded RANGE and column
status with them; gathers the frame from those ranges and the per-column
poses the engine predicted (reference/lut.py), crops and downsamples it
(reference/kiss_map.py); works out the adaptive threshold from the
registrations of the pass so far (each initial guess and registered
pose); registers its own source points against the program's map, from
the same initial guess and for as many steps as the program took
(reference/icp.py, float64); and updates the program's map before the
update with its own downsampled frame at the program's pose. The numbers
compared: the scan's mismatches, the gathered points' largest gap, the
source points that differ from the reference's, the threshold's relative
gap, the largest distance between a source point moved by the program's pose and
by the reference's, the voxels of the map after the update that differ
(missing, extra, another count of points, or a point in another voxel)
and the largest gap of a map point. The trajectory against the drive's
ground truth is printed and not compared: the odometry's own error, a few
centimetres a frame, hides a change of precision. The control: the
gathered points in float32, the registration's inputs in bfloat16 and the
threshold in float32, the next precisions below the program's.

Traffic keys: frames, drive (speed_m, yaw_deg, ramp_frames), data
(noise_mm, dropout_share, second_share), slam (SlamConfig's backend,
voxel_size, min_range, max_range), kiss (the map's and the threshold's
parameters: KISS-ICP's max_points_per_voxel, initial_threshold,
min_motion_th), warm_frames, sample (share, max_scans, first_at), limits.
"""

from __future__ import annotations

import os
import time

import numpy as np

from portbench.lib import synth, yard
from portbench.lib.harness import count_passes
from portbench.reference import icp, kiss_map
from portbench.reference.lut import Lut

# a source point matches the reference's within 0.1 mm: float32 rounds a
# coordinate of the 100 m range by under 4 um
SOURCE_TOL_M = 1e-4


def _snapshot(vmap):
    """(point count of each voxel, their points) of a VoxelHashMap."""
    vals = list(vmap._voxels.values())
    if not vals:
        return np.zeros(0, np.int64), np.zeros((0, 3))
    return (np.fromiter(map(len, vals), np.int64, len(vals)),
            np.concatenate(vals).astype(np.float64))


class Driver:
    def __init__(self, cell, seed, device, variant, workdir):
        self.cell, self.seed, self.device = cell, seed, device
        self.variant, self.workdir = variant, workdir
        self.t = cell.traffic
        self.meta = cell.config["metadata"]
        self.sensor = synth.Sensor(self.meta)
        self.units = self.attempted = self.failed = 0
        self.window_s = 0.0
        self.calls = {}
        self.passes = []          # (frame ids, poses, whether it ended)
        self.history = []         # this pass's (initial guess, pose)
        self.samples = []         # what the check needs of a sampled scan
        self.sampling, self.capture = False, False

    def setup(self) -> None:
        n = self.t["frames"]
        self.dist = yard.cached_distances(
            os.path.join(self.workdir, "yard_distances.npy"), self.meta,
            self.t["drive"], n)
        self.path = synth.write_capture(self.workdir, self.meta, (
            yard.frame(self.sensor, self.dist[k], self.t["data"], self.seed,
                       k) for k in range(n)))
        import torch
        import ouster_sdk_tpu_torch as pt
        from ouster_sdk_tpu_torch import slam

        self.torch, self.pt, self.slam = torch, pt, slam
        with open(self.path[:-len(".pcap")] + ".json") as f:
            self.info = pt.SensorInfo(f.read())
        self._install()
        from portbench.lib.trace import Spans

        self._pass(Spans(), None, self.t["warm_frames"])
        self.units, self.passes = 0, []

    def _install(self) -> None:
        """Wrap the gather, the threshold, the registration and the map
        update: in a scan the sample takes, keep what the check needs; in
        the control, round the gathered points and the threshold to
        float32 and the registration's inputs to bfloat16."""
        import torch
        from ouster_sdk_tpu_torch.slam import device_icp, engine, kiss_icp

        own = [(engine.SlamEngine, "_gather_frame"),
               (device_icp, "register_points_device"),
               (device_icp.DeviceICP, "register_frame"),
               (kiss_icp.AdaptiveThreshold, "compute_threshold"),
               (kiss_icp.VoxelHashMap, "update")]
        self._orig = [(o, a, o.__dict__[a]) for o, a in own]
        (gather, register, register_frame, threshold,
         update) = [f for _, _, f in self._orig]
        drv, control = self, self.variant == "control"

        def gather_frame(eng, scans, mid_pose_inv):
            pts = gather(eng, scans, mid_pose_inv)
            if control:
                pts = pts.astype(np.float32).astype(np.float64)
            drv.capture = drv.sampling and drv._keep()
            if drv.capture:
                s = scans[0]
                drv.samples.append(dict(
                    frame_id=int(s.frame_id),
                    range=np.array(s.field("RANGE")),
                    status=np.array(s.status), pose=np.array(s.pose),
                    mid_inv=np.array(mid_pose_inv), pts=np.array(pts),
                    history=list(drv.history)))
            return pts

        def compute_threshold(th):
            sigma = threshold(th)
            if control:
                sigma = float(np.float32(sigma))
            if drv.capture:
                drv.samples[-1]["sigma"] = sigma
            return sigma

        def register_points(src, src_valid, map_pts, map_valid, init,
                            max_corr, kernel, **kw):
            stats = kw.get("stats")
            if stats is None:
                stats = kw["stats"] = {}
            args = (src, map_pts)
            if control:
                args = tuple(a.to(torch.bfloat16).to(torch.float32)
                             for a in args)
            pose = register(args[0], src_valid, args[1], map_valid, init,
                            max_corr, kernel, **kw)
            if drv.capture:
                drv.samples[-1].update(
                    src=args[0].cpu().numpy().astype(np.float64),
                    iterations=stats["iterations"],
                    reg_pose=pose.cpu().numpy().astype(np.float64))
            return pose

        def frame_registered(icp_, frame, initial_guess, update_map=True):
            if drv.capture:
                # the map the scan registers against (the first frames
                # clear it before their update)
                drv.samples[-1].update(
                    guess=np.array(initial_guess, np.float64),
                    map_reg=_snapshot(icp_.local_map))
            pose = register_frame(icp_, frame, initial_guess, update_map)
            drv.history.append((np.array(initial_guess, np.float64),
                                np.array(pose, np.float64)))
            return pose

        def map_update(vmap, points, pose):
            rec = drv.samples[-1] if drv.capture else None
            if rec is not None:
                rec.update(map_before=_snapshot(vmap),
                           map_pose=np.array(pose, np.float64))
            update(vmap, points, pose)
            if rec is not None:
                rec["map_after"] = _snapshot(vmap)

        for (owner, attr, _), fn in zip(self._orig, (
                gather_frame, register_points, frame_registered,
                compute_threshold, map_update)):
            setattr(owner, attr, fn)

    def _pass(self, spans, deadline, limit=None) -> bool:
        cfg = self.slam.SlamConfig(**self.t["slam"])
        engine = self.slam.SlamEngine([self.info], cfg, device=self.device)
        src = self.pt.open_source(self.path, device=str(self.device))
        ids, poses, hit = [], [], False
        self.history = []
        try:
            for scans in spans.iterate(iter(src), "source"):
                engine.update(scans)
                poses.append(engine.last_pose.copy())
                ids.append(scans[0].frame_id)
                self.units += 1
                if deadline is not None and time.perf_counter() >= deadline:
                    self.window_s = time.perf_counter() - self.t0
                    hit = True
                    break
                if limit is not None and len(ids) >= limit:
                    break
        finally:
            src.close()
        self.passes.append((np.asarray(ids, np.int64), np.asarray(poses),
                            not hit and limit is None))
        return hit

    def window(self, seconds: float, spans) -> None:
        sample = self.t["sample"]
        rng = np.random.default_rng([self.seed % (1 << 63), 3])

        def keep() -> bool:
            n = len(self.samples)
            at = sum(len(p[0]) for p in self.passes)
            return n < sample["max_scans"] and (
                (n == 0 and self.units - at >= sample["first_at"])
                or rng.random() < sample["share"])

        self._keep = keep
        self.sampling = True
        if spans.on:
            from ouster_sdk_tpu_torch.slam import device_icp, engine, kiss_icp

            spans.wrap(engine.SlamEngine, "_gather_frame", "gather")
            spans.wrap(device_icp.DeviceICP, "register_frame", "register")
            spans.wrap(kiss_icp.VoxelHashMap, "update", "map_update")
        self.t0 = time.perf_counter()
        deadline = self.t0 + seconds
        while not self._pass(spans, deadline):
            pass
        self.sampling = False

    def release(self) -> None:
        for owner, attr, orig in self._orig:
            setattr(owner, attr, orig)
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------
    def _compare(self, rec, lut) -> dict:
        """Every number of one sampled scan, against the reference."""
        cfg, kiss = self.t["slam"], self.t["kiss"]
        voxel, inf = cfg["voxel_size"], float("inf")
        out = dict(scan=0, gather=inf, source=0, threshold=inf,
                   register=0.0, map=0, map_m=0.0)
        k = rec["frame_id"] - 1
        if not 0 <= k < self.t["frames"]:
            out.update(scan=1, source=1, map=1, register=inf, map_m=inf)
            return out
        frame = yard.frame(self.sensor, self.dist[k], self.t["data"],
                           self.seed, k)
        rng, status = frame["fields"]["RANGE"], frame["status"]
        if rec["range"].shape != rng.shape \
                or rec["status"].shape != status.shape:
            out["scan"] = rng.size
        else:
            out["scan"] = int(np.count_nonzero(rec["range"] != rng)
                              + np.count_nonzero(rec["status"] != status))
        # the gather, from the ranges as written
        r_m = rng * 0.001
        valid = (rng > 0) & (status & 1).astype(bool)[None, :] \
            & (r_m > cfg["min_range"]) & (r_m < cfg["max_range"])
        rel = rec["mid_inv"][None] @ rec["pose"]
        world = np.einsum("wij,hwj->hwi", rel[:, :3, :3], lut(rng)) \
            + rel[None, :, :3, 3]
        ref = world[valid]
        if ref.shape == rec["pts"].shape:
            out["gather"] = float(np.abs(ref - rec["pts"]).max()) \
                if len(ref) else 0.0
        frame_ds = kiss_map.downsample(
            kiss_map.crop(ref, cfg["min_range"], cfg["max_range"]),
            0.5 * voxel)
        source = kiss_map.downsample(frame_ds, 1.5 * voxel)
        sigma = kiss_map.threshold(rec["history"], kiss["initial_threshold"],
                                   kiss["min_motion_th"], cfg["max_range"])
        if "sigma" in rec:
            out["threshold"] = abs(rec["sigma"] - sigma) / sigma
        before, _ = kiss_map.voxels_of(*rec["map_before"], voxel) \
            if "map_before" in rec else ({}, 0)
        if "src" in rec:
            # the registration, from the reference's source points
            src = rec["src"]
            out["source"] = abs(len(src) - len(source)) if len(src) != len(
                source) else int(np.count_nonzero(
                    np.abs(src - source).max(axis=1) > SOURCE_TOL_M))
            torch = self.torch
            as_t = dict(dtype=torch.float64, device=self.device)
            src_t = torch.as_tensor(source, **as_t)
            map_t = torch.as_tensor(rec["map_reg"][1], **as_t)
            want = icp.register(src_t, map_t,
                                torch.as_tensor(rec["guess"], **as_t),
                                3.0 * sigma, sigma / 3.0, voxel,
                                rec["iterations"])
            d = torch.as_tensor(rec["reg_pose"], **as_t) - want
            moved = src_t @ d[:3, :3].T + d[:3, 3]
            out["register"] = float(torch.linalg.vector_norm(moved, dim=1)
                                    .max()) if len(source) else 0.0
        if "map_after" not in rec:
            out.update(map=1, map_m=inf)
            return out
        want = kiss_map.update(before, frame_ds, rec["map_pose"], voxel,
                               kiss["max_points_per_voxel"],
                               cfg["max_range"])
        got, misplaced = kiss_map.voxels_of(*rec["map_after"], voxel)
        wrong, worst = kiss_map.difference(got, want)
        out.update(map=misplaced + wrong, map_m=worst)
        return out

    def _truth(self):
        """(largest error of a cruising frame's translation step, largest
        drift from the first cruising frame), metres, over every pass."""
        n, ramp = self.t["frames"], self.t["drive"]["ramp_frames"]
        truth = yard.truth(self.t["drive"], n, self.sensor.w)
        gt = np.linalg.inv(truth[0]) @ truth
        d_err = drift = 0.0
        for ids, poses, _ in self.passes:
            m = min(len(ids), n)
            if m <= ramp + 1:
                continue
            t_est = poses[ramp:m, :3, 3]
            t_gt = gt[np.clip(ids[ramp:m] - 1, 0, n - 1), :3, 3]
            step = np.diff(t_est, axis=0) - np.diff(t_gt, axis=0)
            d_err = max(d_err, float(np.linalg.norm(step, axis=1).max()))
            moved = (t_est - t_est[0]) - (t_gt - t_gt[0])
            drift = max(drift, float(np.linalg.norm(moved, axis=1).max()))
        return d_err, drift

    def check(self):
        import sys

        self.attempted, lost = count_passes(
            [(ids, whole) for ids, _, whole in self.passes],
            self.t["frames"])
        self.failed = lost
        step, drift = self._truth()
        registered = sum("src" in r for r in self.samples)
        print(f"info trajectory against the ground truth, cruising: step "
              f"error {step!r} m, drift {drift!r} m; sampled scans "
              f"{len(self.samples)}, registrations {registered}",
              file=sys.stderr)
        lut = Lut(self.meta)
        per = [self._compare(r, lut) for r in self.samples]
        names = (("scan_mismatches", "scan"), ("gather_err_m", "gather"),
                 ("source_mismatches", "source"),
                 ("threshold_rel_err", "threshold"),
                 ("register_err_m", "register"),
                 ("map_mismatches", "map"), ("map_err_m", "map_m"))
        lim = self.t["limits"]
        # nothing sampled, or no sampled registration: nothing was judged
        judged = registered > 0
        out = [(name, max(p[key] for p in per) if judged else float("inf"),
                lim[name]) for name, key in names]
        return out + [("scans_lost", lost, lim["scans_lost"])]
