"""Measure the planar projection kernel on an NVIDIA GPU.

    python -m ouster_sdk_tpu_torch.kernels.bench_planar [phases] [options]

Phases (default: check times profile):

  check    every planar case through the wrapper against the plain version
           on the card, bit for bit, at 128x2048 (B=8) and at 40x496 (B=11,
           no multiple of any tile)
  times    the wrapper call of the six cases at B=32 and B=128: median, min
           and max of 7 CUDA-event windows of 50 warm calls, and the host's
           time to issue one call
  profile  a torch.profiler trace of one warm wrapper call with poses
           (128x2048 dual, B=32): every device kernel and copy by name
  sweep    the launch geometries of kernels/planar_project.TUNING on the
           main case with and without poses (B=32 and B=128)

Inputs are random words made from a seed (about 5 % of ranges zero, 3 % of
columns with their status bit cleared) for a synthetic 128-beam sensor.

`--root DIR` measures the package of another checkout (DIR holds
ouster_sdk_tpu_torch/), e.g. the parent commit unpacked beside this one:
run this file as a script, `python path/to/bench_planar.py --root DIR`.
Compare two versions only within one run on one card. Every result is
printed as one JSON line, with the card's name and power limit in the
first.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

CASE_PROFILE = {"planar": ("RNG19_RFL8_SIG16_NIR16", 2048),
                "planar_dual": ("RNG19_RFL8_SIG16_NIR16_DUAL", 2048),
                "planar_dual_split": ("RNG19_RFL8_SIG16_NIR16_RGB16_DUAL",
                                      1024)}


def emit(**kv) -> None:
    print(json.dumps(kv), flush=True)


def kernel_profile(fn):
    """Run `fn` once warm under torch.profiler and return what ran on the
    device as [(name, count, microseconds)], kernels and copies alike."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, int(e.count), float(us)))
    return rows


def cuda_ms(fn, iters: int = 50, windows: int = 7, warm: int = 5):
    """Median, min and max over `windows` CUDA-event windows of `iters`
    back-to-back calls, in ms per call."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times)), min(times), max(times)


def host_issue_ms(fn, iters: int = 50, windows: int = 5) -> float:
    """Host time to issue one call, without waiting for the device: the
    least of `windows` windows of `iters` calls (the host's cores are
    shared, so the least is the call's own cost)."""
    import torch

    best = float("inf")
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    torch.cuda.synchronize()
    return best


def synth_info(port, profile: str, w: int, h: int):
    from ouster_sdk_tpu_torch.core.types import (DataFormat, LidarMode,
                                                 UDPProfileLidar)

    info = port.default_sensor_info(LidarMode(1024, 10))
    info.format = DataFormat(
        pixels_per_column=h, columns_per_packet=16, columns_per_frame=w,
        pixel_shift_by_row=[12, 8, 4, 0] * (h // 4), column_window=(0, w - 1),
        udp_profile_lidar=UDPProfileLidar(profile), fps=10)
    info.config.lidar_mode = LidarMode(w, 10)
    info.beam_azimuth_angles = [3.164, 1.055, -1.055, -3.164] * (h // 4)
    info.beam_altitude_angles = list(np.linspace(22.5, -22.5, h))
    return info


def random_words(pk, plan, dual: bool, B: int, seed: int):
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 1 << 32, (B, plan.pw, plan.h, plan.w),
                          dtype=np.uint32)
    for f in pk._range_fields(plan, dual):
        mask = np.uint32(~(((1 << f.size) - 1) << f.bit) & 0xFFFFFFFF)
        zero = rng.random((B, plan.h, plan.w)) < 0.05
        planes[:, f.word][zero] &= mask
    hdrs = rng.integers(0, 1 << 32, (B, plan.schw, plan.w), dtype=np.uint32)
    bit = np.uint32(1 << plan.status_bit)
    hdrs[:, plan.staged_status_word] |= bit
    off = rng.random((B, plan.w)) < 0.03
    hdrs[:, plan.staged_status_word][off] &= ~bit
    return planes, hdrs


def random_poses(B: int, w: int, seed: int) -> np.ndarray:
    """(B, w, 4, 4) float32 rigid poses from random unit quaternions."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, w, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    a, b, c, d = np.moveaxis(q, -1, 0)
    T = np.zeros((B, w, 4, 4))
    T[..., :3, :3] = np.stack([
        np.stack([a*a + b*b - c*c - d*d, 2*(b*c - a*d), 2*(b*d + a*c)], -1),
        np.stack([2*(b*c + a*d), a*a - b*b + c*c - d*d, 2*(c*d - a*b)], -1),
        np.stack([2*(b*d - a*c), 2*(c*d + a*b), a*a - b*b - c*c + d*d], -1),
    ], -2)
    T[..., :3, 3] = rng.normal(0, 3, (B, w, 3))
    T[..., 3, 3] = 1
    return T.astype(np.float32)


class Bench:
    def __init__(self, device: str = "cuda"):
        import torch
        import ouster_sdk_tpu_torch as port
        from ouster_sdk_tpu_torch.ops import planar_kernels as pk

        self.torch, self.port, self.pk = torch, port, pk
        self.dev = torch.device(device)
        self._pipes = {}

    def pipe(self, profile: str, w: int, h: int = 128):
        key = (profile, w, h)
        if key not in self._pipes:
            self._pipes[key] = self.port.ScanPipeline(
                synth_info(self.port, profile, w, h), device=self.dev)
        return self._pipes[key]

    def case(self, case: str, B: int, w=None, h: int = 128, seed: int = 1):
        """(kernel call, plain call) of one case on B random frames."""
        dewarp = case.endswith("_dewarp")
        profile, w0 = CASE_PROFILE[case.replace("_dewarp", "")]
        pipe = self.pipe(profile, w or w0, h)
        pk, plan = self.pk, pipe.plan
        base = min(B, 8)    # B > 8 repeats the frames, as the smoke run does
        planes, hdrs = random_words(pk, plan, pipe.dual, base, seed)
        reps = -(-B // base)
        planes = pk.words_tensor(planes, self.dev).repeat(
            reps, 1, 1, 1)[:B].contiguous()
        hdrs = pk.words_tensor(hdrs, self.dev).repeat(
            reps, 1, 1)[:B].contiguous()
        poses = (self.torch.from_numpy(random_poses(B, plan.w, seed + 1))
                 .to(self.dev) if dewarp else None)
        args = (planes, hdrs, pipe.planar_lut.stack, plan)
        kw = dict(dual=pipe.dual, poses=poses)
        return (lambda: pk.unpack_project_planar_batched(*args, **kw),
                lambda: pk.unpack_project_planar_batched_plain(*args, **kw))

    # -- phases --------------------------------------------------------------

    def check(self) -> bool:
        ok = True
        for case in self.pk.CASES:
            for B, w, h in ((8, None, 128), (11, 496, 40), (1, 496, 40)):
                kernel, plain = self.case(case, B, w, h, seed=3)
                got, want = kernel(), plain()
                self.torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                n_diff = sum(int((g.view(self.torch.int32)
                                  != p.view(self.torch.int32)).sum())
                             for g, p in zip(got, want))
                ok &= n_diff == 0
                emit(phase="check", case=case, B=B, shape=list(got[0].shape),
                     n_diff=n_diff)
        return ok

    def times(self, cases=None, batches=(32, 128)) -> None:
        for case in cases or self.pk.CASES:
            for B in batches:
                kernel, _ = self.case(case, B)
                ms, lo, hi = cuda_ms(kernel)
                emit(phase="times", case=case, B=B, ms=ms, min=lo, max=hi,
                     host_issue_ms=host_issue_ms(kernel))

    def profile(self) -> None:
        for case in ("planar_dual_dewarp", "planar_dual"):
            kernel, _ = self.case(case, 32)
            rows = kernel_profile(kernel)
            emit(phase="profile", case=case, B=32,
                 device_events=[dict(name=n, count=c, us=us)
                                for n, c, us in rows],
                 total_us=sum(us for _, _, us in rows))

    def sweep(self) -> None:
        from ouster_sdk_tpu_torch.kernels import planar_project as binding

        tuning = getattr(binding, "TUNING", None)
        if tuning is None:
            emit(phase="sweep", skipped="this package has no TUNING")
            return
        keep = dict(tuning)
        calls = {(c, B): self.case(c, B)[0]
                 for c in ("planar_dual_dewarp", "planar_dual",
                           "planar_dewarp", "planar")
                 for B in (32, 128)}
        shapes = ((16, 8), (16, 16), (32, 4), (32, 8), (64, 4))
        try:
            for (tx, ty), ry, fpb in itertools.product(
                    shapes, (1, 2, 4, 8), (4, 8, 16)):
                tuning.update(tx=tx, ty=ty, fpb=fpb, ry=ry)
                row = dict(phase="sweep", **tuning)
                try:
                    for (c, B), fn in calls.items():
                        row[f"{c}_{B}"] = cuda_ms(fn, iters=20, windows=5,
                                                  warm=2)[0]
                except RuntimeError as e:   # a geometry the card refuses
                    row["refused"] = str(e)
                emit(**row)
        finally:
            tuning.update(keep)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="*",
                    default=["check", "times", "profile"])
    ap.add_argument("--root", default=None,
                    help="checkout whose package is measured")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--tuning", default=None,
                    help="JSON object of TUNING entries to override")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(args.root or os.path.join(here, "..", ".."))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        print("bench_planar: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit(label=args.label, root=root, card=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    from ouster_sdk_tpu_torch.kernels import build
    build.load("planar_project.cu")
    for src, (log, secs) in build.build_log.items():
        emit(phase="build", source=src, seconds=secs,
             ptxas=[ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling" in ln])
    if args.tuning:
        from ouster_sdk_tpu_torch.kernels import planar_project as binding
        binding.TUNING.update(json.loads(args.tuning))
        emit(tuning=binding.TUNING)
    bench = Bench()
    ok = True
    for phase in args.phases:
        result = getattr(bench, phase)()
        ok &= result is not False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
