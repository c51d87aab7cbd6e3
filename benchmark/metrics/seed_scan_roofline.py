"""The seed-scan kernel's share of its roofline: the least time of a
launch (harness.roofline.seed_scan_cost from its rows, reads and anchor
offsets) over the device time of a launch in the trace, averaged over the
window's launches."""

from harness import roofline

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "kernels", "reads_per_s"


def read(ctx):
    tr, shapes = ctx["trace"], ctx["shapes"].get("seed_scan")
    if not tr or not shapes:
        return None
    n, dev_s = tr["kernels"].get("seed_scan", (0, 0.0))
    if not n:
        return None
    costs = [roofline.seed_scan_cost(*sh) for sh in shapes]
    return roofline.share(costs, dev_s / n * len(costs), ctx["kind"])
