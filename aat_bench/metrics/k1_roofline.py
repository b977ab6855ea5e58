"""K1's share of its roofline: the least time of every K1 call in the
window (``yardstick.k1_work``: the real residues' codes, the query, the
table and the scores over the HBM rate, or 11 float32 operations per
needed cell over the float32 rate, whichever is larger) over the device
time of the kernels launched inside the benchmark's span around
``ops.swaffine.sw_affine_scores``.  A call's real residues are the
library's, in the share of its templates the call holds."""

from aat_bench import yardstick

SPANS = {"k1": "alignment_algos_tpu_torch.ops.swaffine:sw_affine_scores"}


def _probe(args, kwargs):
    q_codes, t_codes, table = args[0], args[1], args[2]
    return {"q": int(q_codes.shape[0]), "n": int(t_codes.shape[1]),
            "a": int(table.shape[0])}


PROBES = {"k1": _probe}


def read(run):
    calls = [s for s in run.spans if s.name == "k1"]
    device_s = sum(s.device_s for s in calls)
    if not calls or device_s <= 0:
        return None
    n_lib, residues = run.inputs["templates"], run.inputs["residues"]
    least = sum(yardstick.least_s(*yardstick.k1_work(
        s.info["q"], residues * s.info["n"] / n_lib, s.info["n"],
        s.info["a"])) for s in calls)
    return 100.0 * least / device_s
