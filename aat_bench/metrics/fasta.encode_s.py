"""The library's pad-encode to (N, Tmax) int32 codes, per completed
screen: the seconds of the program's span ``fasta.encode``
(``cli/screen.read_inputs``), host clock, no synchronize."""

from aat_bench import program_spans


def read(run):
    return program_spans.mean_s(run, "fasta.encode")
