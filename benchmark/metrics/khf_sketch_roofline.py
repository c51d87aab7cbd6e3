"""The KHF-sketch kernel's share of its roofline: the least time of a
launch (harness.roofline.khf_sketch_cost at the launch's shapes) over the
device time of a launch in the trace, averaged over the window's launches."""

from harness import roofline

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "kernels", "reads_per_s"


def read(ctx):
    tr, shapes = ctx["trace"], ctx["shapes"].get("khf_sketch")
    if not tr or not shapes:
        return None
    n, dev_s = tr["kernels"].get("khf_sketch", (0, 0.0))
    if not n:
        return None
    costs = [roofline.khf_sketch_cost(*sh) for sh in shapes]
    return roofline.share(costs, dev_s / n * len(costs), ctx["kind"])
