"""The mesh's drain, per completed screen: the seconds of the program's
span ``mesh.drain`` (``parallel/screen.screen_library``: the pull of
every shard's candidates, which waits for the slowest card, then the host
merge), host clock, no synchronize of the program's own."""

from aat_bench import program_spans


def read(run):
    return program_spans.mean_s(run, "mesh.drain")
