"""Builds the program's index of a configuration's genome with the
program's own builder and saves it where the harness loads it: the
user's `index` step, run once per checkout, in a process of its own so
that its memory does not count in the mapping process's.

    python perfbench/core/port_index.py <cache_dir> <config.json>
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from core import genome as genome_mod  # noqa: E402

INDICATOR = "index"


def main(cache_dir: str, config_path: str) -> int:
    from bucketmap_tpu_torch.config import MapperConfig
    from bucketmap_tpu_torch.index.builder import build_index, save_index
    from bucketmap_tpu_torch.io.fasta import FastaRecord

    with open(config_path) as f:
        cfg = json.load(f)
    g = genome_mod.load(os.path.join(cache_dir, "genome"))
    recs = [FastaRecord(id=name, codes=g.codes(i, 0, n))
            for i, (name, n) in enumerate(zip(g.names, g.lengths))]
    index = build_index(recs, MapperConfig(**cfg["mapper"]))
    del recs
    out = os.path.join(cache_dir, "index")
    tmp = out + ".tmp"
    save_index(index, tmp, INDICATOR, overwrite=True)
    os.replace(tmp, out)
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & {"jax", "jaxlib", "flax", "bucketmap_tpu"})
    if found:
        print(f"[port_index] loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
