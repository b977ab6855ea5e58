"""Profile rows parsed per second: the ``rows`` the program counts in its
span ``profile.read`` (``cli/screen.read_profiles``: the query's and every
template's ``size()``) over that span's seconds, summed over the window's
screens."""

from aat_bench import program_spans


def read(run):
    return program_spans.rate(run, "profile.read", "rows")
