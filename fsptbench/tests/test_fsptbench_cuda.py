"""Runs on the card (marker `cuda`; they skip without one):

    python3 -m pytest -s -m cuda fsptbench/tests/test_fsptbench_cuda.py

Every cell once at its full size with a short window, and the train
cell's faults at its full size on three seeds, their readings printed
(the readings a train number's upper limit is held against)."""

import json

import pytest

from fsptbench.manifest import Manifest
from fsptbench.run import run_cell
from test_fsptbench_faults import CELLS, _altered_hits, _half_batch

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cuda, cell):
    r = run_cell(cell, 6_100_000_001, 2.0, False, cuda,
                 Manifest(parked=True))
    assert r["correct"], r["checks"]
    assert r["device"]["memory_peak_bytes"] > 0


@pytest.mark.parametrize("seed", [6_200_000_001, 6_200_000_002,
                                  6_200_000_003])
@pytest.mark.parametrize("fault", [_half_batch, _altered_hits],
                         ids=["half_batch", "answer_altered"])
def test_train_faults_on_card(cuda, fault, seed, monkeypatch):
    fault(monkeypatch)
    r = run_cell("bunny8_main.train", seed, 1.0, False, cuda, Manifest())
    print("fault", fault.__name__, seed, json.dumps(
        {k: v["value"] for k, v in r["checks"].items()}))
    assert not r["correct"], r["checks"]
