"""Host-side scene compilation (a jax-free copy of fspt_tpu.scene: parsers,
atlas packing, environment analysis, BVH construction and flattening into
SceneArrays).  tests/test_torch_scene.py holds it to the original."""
