"""The dry run's tools (the counterparts of ``benchmarks/roofline_report.py``
and ``scripts/render_experiments.py``, ``zero_memory_table.py`` and
``profile_pair.py``), each ``python -m repro_torch.tools.<name>``; they
read and write ``results/torch/`` under the checkout."""
import json
import os

RESULTS = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "torch"))


def load(path) -> dict:
    """``{(arch, shape): record}`` of a dry run's JSONL (the last record of
    a pair wins); empty where the file is missing."""
    recs = {}
    if not os.path.exists(path):
        return recs
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            recs[(r["arch"], r["shape"])] = r
    return recs
