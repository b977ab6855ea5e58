"""Reading the query and library FASTA files and the matrix, per
completed screen: the seconds of the program's span ``fasta.read``
(``cli/screen.read_inputs``), host clock, no synchronize."""

from aat_bench import program_spans


def read(run):
    return program_spans.mean_s(run, "fasta.read")
