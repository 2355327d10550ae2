"""The share of the window that the main thread (the one that runs
`map_fastq`) spends in none of its `BucketMapPipeline.stage` spans: 100
times one less the union of those spans over the window."""

import threading


def read(ctx):
    main = threading.main_thread().ident
    spans = sorted((t0, t1) for tid, layer, _, t0, t1 in ctx["clock"].spans
                   if tid == main and layer == "pipeline")
    window_s = ctx["window_s"]
    if not spans or not window_s:
        return None
    covered, end = 0, None
    for t0, t1 in spans:
        if end is None or t0 > end:
            covered += t1 - t0
            end = t1
        elif t1 > end:
            covered += t1 - end
            end = t1
    return 100.0 * (1.0 - covered / 1e9 / window_s)
