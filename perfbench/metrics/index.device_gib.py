"""GiB the device holds once the pipeline is built, before the warm-up:
the index's tables (`torch.cuda.memory_allocated`)."""


def read(ctx):
    return ctx["index_device_gib"]
