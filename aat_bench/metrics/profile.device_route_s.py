"""The device route (library pack, copy, K5, K6, K3, pull), per completed
screen: the seconds of the benchmark's span around
``alignment_algos_tpu_torch.ops.hmap_device:screen_hmap_device``, host
clock, ending after a device synchronize."""

SPANS = {"profile.device_route":
         "alignment_algos_tpu_torch.ops.hmap_device:screen_hmap_device"}


def read(run):
    return run.span_mean_s("profile.device_route")
