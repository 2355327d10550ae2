"""A CPU rehearsal of one run in a fresh process:

    python rehearse.py <root> <fault, probe, - or control> <arguments...>

It skips the harness's look for a card and builds the program's
pipeline on the CPU, where it runs its kernels' plain versions; a fault
or a probe of faults.py is planted in the pipeline as it is built.
With `control`, the arguments are control.py's, and the control runs in
the program's place."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PERFBENCH = os.path.dirname(HERE)
sys.path[:0] = [HERE, PERFBENCH, os.path.dirname(PERFBENCH)]

import control  # noqa: E402
import faults  # noqa: E402
import run  # noqa: E402


def on_the_cpu(plant=None) -> None:
    """run.py's card check passed, and BucketMapPipeline built on the CPU
    with `plant` applied to it."""
    from bucketmap_tpu_torch.mapper import pipeline

    base = pipeline.BucketMapPipeline

    class OnTheCpu(base):
        def __init__(self, index, **kw):
            super().__init__(index, **dict(kw, device="cpu"))
            if plant is not None:
                plant(self)

    pipeline.BucketMapPipeline = OnTheCpu
    run.card_ok = lambda torch, chips: True


if __name__ == "__main__":
    root, fault, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
    if fault == "control":
        on_the_cpu()
        sys.exit(control.main(argv, root=root))
    on_the_cpu(None if fault == "-"
               else {**faults.FAULTS, **faults.PROBES}[fault])
    sys.exit(run.main(argv, root=root))
