"""The library's copy to the card in GB/s: the ``h2d_bytes`` the program
counts in its span ``to_device.copy`` (``ops/swaffine.to_device``) under
``screen.library``, over that span's seconds, summed over the window's
screens.  A copy from pageable memory returns once its last bytes are
staged for the card, so the span holds all but the last of the DMA."""

from aat_bench import program_spans


def read(run):
    got = program_spans.rate(run, "to_device.copy", "h2d_bytes",
                             "screen.library")
    return got / 1e9 if got is not None else None
