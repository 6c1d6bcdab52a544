"""The import check: top-level names compared whole."""

import os

from fsptbench import importcheck


def test_tree_passes():
    assert importcheck.violations() == []


def test_top_level_names_compared_whole():
    mods = ["fspt_tpu_torch", "fspt_tpu_torch.ops.traverse4", "numpy",
            "jaxtyping", "fspt_tpu_torchvision"]
    assert importcheck.loaded(mods) == []
    assert importcheck.loaded(mods + ["fspt_tpu.core"]) == ["fspt_tpu"]
    assert importcheck.loaded(["jax._src", "flax"]) == ["flax", "jax"]


def test_planted_imports_are_found(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "bad.py").write_text(
        "import numpy\nfrom fspt_tpu_torch.core import rng\n")
    (tmp_path / "harness.py").write_text(
        "import fspt_tpu_torch\n"
        "def f():\n    import jax.numpy as jnp\n"
        "    return __import__('fspt_tpu')\n")
    bad = importcheck.violations(str(tmp_path))
    ref = os.path.join("reference", "bad.py")
    assert f"{ref}: fspt_tpu_torch.core" in bad
    assert "harness.py: jax.numpy" in bad
    assert "harness.py: fspt_tpu" in bad
    assert "harness.py: fspt_tpu_torch" not in bad


def test_generators_are_held_to_the_reference_rule(tmp_path):
    (tmp_path / "generators").mkdir()
    (tmp_path / "generators" / "mesh.py").write_text(
        "import numpy as np\nfrom fspt_tpu_torch.testing import "
        "make_test_scene\n")
    (tmp_path / "generators" / "sky.py").write_text("import numpy\n")
    assert importcheck.violations(str(tmp_path)) == [
        os.path.join("generators", "mesh.py") + ": fspt_tpu_torch.testing"]


def test_the_process_of_a_cpu_run_holds_no_jax():
    # the benchmark's own modules, the program and the reference
    import fsptbench.drive  # noqa: F401
    import fsptbench.run  # noqa: F401
    import fspt_tpu_torch  # noqa: F401
    import sys
    extra = [m for m in sys.modules if importcheck.top(m) == "fspt_tpu"]
    # the repository's own test suite may load the JAX package into a
    # shared process; the benchmark's modules must not be why
    for name in ("fsptbench.drive", "fsptbench.run", "fsptbench.reference.render"):
        src = sys.modules[name].__file__
        assert not [m for m in importcheck.imports_of(src)
                    if importcheck.top(m) in importcheck.FORBIDDEN], extra
