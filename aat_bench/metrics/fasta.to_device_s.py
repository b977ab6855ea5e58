"""The library's transpose and copy to the card, per completed screen: the
seconds of the benchmark's span around
``alignment_algos_tpu_torch.parallel.screen:to_device``, host clock,
ending after a device synchronize."""

SPANS = {"fasta.to_device":
         "alignment_algos_tpu_torch.parallel.screen:to_device"}


def read(run):
    return run.span_mean_s("fasta.to_device")
