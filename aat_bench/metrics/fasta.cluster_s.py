"""Hit clustering (K2, K8, ali_dist, UPGMA), per completed screen: the
seconds of the benchmark's span around
``alignment_algos_tpu_torch.cli.screen:_cluster_hits``, host clock,
ending after a device synchronize."""

SPANS = {"fasta.cluster": "alignment_algos_tpu_torch.cli.screen:_cluster_hits"}


def read(run):
    return run.span_mean_s("fasta.cluster")
