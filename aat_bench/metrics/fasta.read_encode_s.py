"""FASTA read and encode (the query, the library, the matrix), per
completed screen: the seconds of the benchmark's span around
``alignment_algos_tpu_torch.cli.screen:read_inputs``, host clock, ending
after a device synchronize."""

SPANS = {"fasta.read_encode":
         "alignment_algos_tpu_torch.cli.screen:read_inputs"}


def read(run):
    return run.span_mean_s("fasta.read_encode")
