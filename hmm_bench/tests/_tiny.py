"""A cell small enough for the CPU: the dogbone at 1 x 1 x 2 cells (16 qps),
8 chains of 8 beads (or 2 x 2 x 2 Si cells), a short staged prep, on the port's
plain kernel versions."""
from __future__ import annotations

import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_conf(name: str = "g0_dogbone", dtype: str = "float64") -> dict:
    with open(os.path.join(ROOT, "hmm_bench", "configs", f"{name}.json")) as f:
        conf = json.load(f)
    conf = copy.deepcopy(conf)
    conf["hmm"]["continuum mesh"]["input"].update({"x cells": 1, "y cells": 1, "z cells": 2})
    conf["prep"] = {"ns_init": 10}
    conf["dtype"] = conf["md_dtype"] = dtype
    if "sw" in name:
        conf["md box"] = {"n_cells_xyz": [2, 2, 2]}
    else:
        conf["md box"] = {"n_chains": 8, "opls_lj_cutoff": 6.0, "validate": False}
    return conf


def traffic() -> dict:
    with open(os.path.join(ROOT, "hmm_bench", "traffic", "steady.json")) as f:
        return json.load(f)
