"""K3's share of its roofline: the least time of every ragged K3 call in
the window (``yardstick.k3_work`` over the call's (n, q2, t2) buckets)
over the device time of the kernels launched inside the benchmark's span
around ``ops.dp_scores.dp_general_ragged``."""

from aat_bench import yardstick

SPANS = {"k3": "alignment_algos_tpu_torch.ops.dp_scores:dp_general_ragged"}


def _probe(args, kwargs):
    return {"shapes": [tuple(int(x) for x in b[0].shape) for b in args[0]]}


PROBES = {"k3": _probe}


def read(run):
    calls = [s for s in run.spans if s.name == "k3"]
    device_s = sum(s.device_s for s in calls)
    if not calls or device_s <= 0:
        return None
    least = sum(yardstick.least_s(*yardstick.k3_work(s.info["shapes"]))
                for s in calls)
    return 100.0 * least / device_s
