"""Build one configuration graph into a cache directory and measure it:

    python3 gnnbench/graph_build.py --spec gnnbench/graphs/mag240m.json \
        --scale 1.0 --cache DIR

Prints one JSON line: the graph's nodes and edges, the build's seconds and
the process's peak host memory after it (``ru_maxrss``), the bytes the
cache holds, the seconds to load the graph back from the cache (files just
written: a warm read), and, with a CUDA device, the seconds to copy
``indptr`` and ``indices`` to it.  ``--scale`` replaces the spec's own.
A multi-GB graph belongs in a directory outside the checkout, removed
after.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spec", required=True, help="a JSON file holding a graph block")
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--cache", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from gnnbench.graph import _cache_name, load_graph
    spec = json.loads(Path(args.spec).read_text())
    if args.scale is not None:
        spec["scale"] = args.scale
    cache = Path(args.cache)
    t0 = time.perf_counter()
    g = load_graph(spec, cache)
    build_s = time.perf_counter() - t0
    out = {"spec": args.spec, "scale": spec.get("scale"), "nodes": g.num_nodes,
           "edges": g.num_edges, "build_s": build_s,
           "peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
           "graph_gib": sum(a.nbytes for a in (g.indptr, g.indices, g.labels)) / 2**30,
           "max_in_degree": int((g.indptr[1:] - g.indptr[:-1]).max())}
    where = cache / _cache_name(spec)
    out["cache_bytes"] = sum(p.stat().st_size for p in where.iterdir())
    del g
    gc.collect()
    t0 = time.perf_counter()
    g = load_graph(spec, cache)
    out["load_s"] = time.perf_counter() - t0
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on = [torch.as_tensor(a).cuda() for a in (g.indptr, g.indices)]
        torch.cuda.synchronize()
        out["upload_s"] = time.perf_counter() - t0
        out["device"] = torch.cuda.get_device_name(0)
        out["device_gib"] = sum(t.numel() * t.element_size() for t in on) / 2**30
        del on
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
