"""The host's feed of the mesh's cards, per completed screen: the seconds
of the program's spans ``mesh.shard`` (``parallel/screen``: each shard's
copy, layout launch, range-check sync, K1 and top-k launches, one shard
after another), summed, host clock, no synchronize of the program's own.
In a traced run the benchmark's spans around ``to_device`` and
``sw_affine_scores`` wait for every card inside them, so each shard's K1
runs inside its ``mesh.shard``."""

from aat_bench import program_spans


def read(run):
    return program_spans.mean_s(run, "mesh.shard", "screen.library")
