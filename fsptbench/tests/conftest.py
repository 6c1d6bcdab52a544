"""Fixtures of the benchmark's CPU tests: a throwaway copy of the
benchmark's data files, cut to a size the CPU renders in seconds."""

import json
import os
import shutil

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def make_small(root, size=64, subdivisions=2):
    """BENCHMARK.json and fsptbench's data files under `root`, every
    configuration at size x size with a bunny of `subdivisions`; the
    manifest has the parked cells merged in."""
    from fsptbench.manifest import Manifest
    bench = os.path.join(root, "fsptbench")
    os.makedirs(bench, exist_ok=True)
    for d in ("configs", "traffic", "checks", "metrics", "parked",
              "generators"):
        if os.path.isdir(os.path.join(BENCH, d)):
            shutil.copytree(os.path.join(BENCH, d), os.path.join(bench, d),
                            dirs_exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["render"].update(width=size, height=size)
        cfg["assets"]["bunny.obj"]["subdivisions"] = subdivisions
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return Manifest(os.path.join(root, "BENCHMARK.json"), bench,
                    parked=True)


@pytest.fixture(autouse=True)
def native_cache(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("FSPT_NATIVE_CACHE",
                       str(tmp_path_factory.getbasetemp() / "native"))


@pytest.fixture(scope="session")
def small(tmp_path_factory):
    return make_small(str(tmp_path_factory.mktemp("small")))


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
