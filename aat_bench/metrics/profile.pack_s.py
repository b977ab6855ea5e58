"""The library's host pack for the card (``DeviceLibrary``: each
template's rows and gap vectors, stacked by length), per completed screen:
the seconds of the program's span ``hmap.pack``
(``ops/hmap_device.DeviceLibrary``), host clock, no synchronize."""

from aat_bench import program_spans


def read(run):
    return program_spans.mean_s(run, "hmap.pack")
