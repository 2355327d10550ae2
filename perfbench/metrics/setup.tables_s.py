"""Seconds to build `BucketMapPipeline` (device tables, the fine table's
device build) through a `torch.cuda.synchronize()`, by the harness's
clock."""


def read(ctx):
    return ctx["tables_s"]
