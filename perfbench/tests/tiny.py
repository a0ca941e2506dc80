"""Cells of the benchmark at a size a CPU test run holds: the real
configuration and traffic files with their scale cut down."""
from __future__ import annotations

import copy

from pbcore import runner

SMALL = {
    "gambia_dstagnn": {"data": {"steps": 100, "nodes_x": 6, "nodes_y": 5, "len_input": 48},
                       "model": {"num_of_vertices": 30, "len_input": 48, "d_model": 16,
                                 "d_k": 8, "d_v": 8, "nb_chev_filter": 16,
                                 "nb_time_filter": 16}},
    "pems08_dstagnn": {"data": {"steps": 120, "nodes": 12},
                       "model": {"num_of_vertices": 12, "nb_block": 2, "d_model": 32,
                                 "d_k": 8, "d_v": 8, "nb_chev_filter": 16,
                                 "nb_time_filter": 16, "batch_size": 8}},
}
TRAFFIC = {"raster_bell_tiles": {"knobs": {"block_size": 8}},
           "roads_fused": {"graph": {"params": {"edges": 16}}},
           "roads_dense": {"graph": {"params": {"edges": 16}}}}


def cell(workload: str) -> dict:
    """The cell's files, cut to the CPU size."""
    c = copy.deepcopy(runner.load_cell(workload))
    for part, over in SMALL[c["config"]["name"]].items():
        c["config"][part].update(over)
    for part, over in TRAFFIC.get(c["cell"]["traffic"], {}).items():
        if isinstance(over, dict) and part in c["traffic"]:
            for k, v in over.items():
                if isinstance(v, dict):
                    c["traffic"][part].setdefault(k, {}).update(v)
                else:
                    c["traffic"][part][k] = v
    return c

