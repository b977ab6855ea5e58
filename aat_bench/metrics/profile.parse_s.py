"""Profile parsing (the query and every template file), per completed
screen: the seconds of the benchmark's span around
``alignment_algos_tpu_torch.cli.screen:read_profiles``, host clock,
ending after a device synchronize."""

SPANS = {"profile.parse": "alignment_algos_tpu_torch.cli.screen:read_profiles"}


def read(run):
    return run.span_mean_s("profile.parse")
