"""wire_project_roofline (%), traced run: the least time the card could take
for the wire replay's planar_project calls in the window (the bytes below,
over the HBM peak) as a share of the device time of the planar_project
kernels in the profiler's trace.

The bytes are the least each call must move: each projected range image's
u32 in and its float32 XYZ out, and the (18, h, w) float32 LUT stack and
one u32 column-header row once a call. The images are the program's
counter `bp64.ranges_decoded` over the window (each decoded image is
projected: the cell decodes its two returns), the calls the
planar_project kernels in it. Nothing where the program counted no image
(an older program) or the trace holds no such kernel."""

from portbench.lib import program_trace, trace
from portbench.lib.roofline import PEAK_BYTES_PER_S
from portbench.lib.synth import Sensor


def wire_project_bytes(images: int, calls: int, h: int, w: int) -> int:
    hw = h * w
    return images * (hw * 4 + 3 * hw * 4) + calls * (18 * hw * 4 + w * 4)


def read(run):
    prog = program_trace.of(run)
    if prog is None:
        return None
    images = sum(n for c, _, n in prog.counts if c == "bp64.ranges_decoded")
    secs, calls = trace.kernel_time(run.device, "planar_project", run.lo,
                                    run.hi)
    if not images or not calls or secs <= 0:
        return None
    s = Sensor(run.cell.config["metadata"])
    return (wire_project_bytes(images, calls, s.h, s.w) / PEAK_BYTES_PER_S
            / secs * 100)
