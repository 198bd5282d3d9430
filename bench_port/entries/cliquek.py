"""k-cliques (k = 4, 5) by graphminer_tpu_torch.ops.cliquek.CliqueKEngine:
set-up relabels and orients the graph (span "prep") and builds the engine
(span "build"): its core bitmaps, its host task enumerator, the sub-core
frontier tail, which it counts there, and the upload. A count is one
launch of kernel G, one of kernel L and the int64 sums read back, plus the
tail counted in set-up."""
from __future__ import annotations

from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.ops.cliquek import CliqueKEngine


def prepare(rowptr, colidx, config, devices, span):
    g = HostGraph(rowptr=rowptr, colidx=colidx)
    args = dict(config.get("entry_args", {}))
    k = int(args.pop("k"))
    with span("prep"):
        rg = g.relabel_by_degree(descending=False).orientation()
    with span("build", devices):
        eng = CliqueKEngine(rg, k, device=devices[0], **args)
    return eng
