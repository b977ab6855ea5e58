"""The library's host transpose to the kernels' (T, N) layout, per
completed screen: the seconds of the program's span ``to_device.layout``
(``ops/swaffine.to_device``) under ``screen.library``, host clock, no
synchronize."""

from aat_bench import program_spans


def read(run):
    return program_spans.mean_s(run, "to_device.layout", "screen.library")
