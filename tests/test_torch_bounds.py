"""The bound of a traversal launch (fspt_tpu_torch.ops.traverse.
traversal_bound) against hand-computed values, and the node/leaf visit
split it is fed against the plain versions' `visits`.

The bound is arithmetic on counts, so it is exact: the cases below are
worked by hand from the published 3.35 TB/s and 67 TFLOP/s of one H100 and
the operation counts the module states (20 a child, 55 a triangle).  The
bound charges a launch for the valid children and the real triangles its
visits tested, not for every slot of a row: an empty child slot and a
leaf's padding slot need no arithmetic.  Both counts and the node/leaf
split come from the plain versions' `counts` tally; on a 32x32 test scene
on the CPU the split must sum to what `visits` reports (per ray for
traverse4, per group and per lane of the group for the group walks), and
the row counts are held to hand-made rows and, for the per-ray walk, to
the sum over one-ray launches.
"""

import pytest
import torch

from fspt_tpu_torch.core.camera import generate_rays
from fspt_tpu_torch.core.rng import key, stream_uniforms
from fspt_tpu_torch.ops.traverse import (SLAB_OPS, TRI_OPS,
                                         packet_traverse_reference,
                                         real_triangles, tally_visits,
                                         traversal_bound, valid_children)
from fspt_tpu_torch.ops.traverse3 import packet_traverse3_reference
from fspt_tpu_torch.ops.traverse4 import packet_traverse4_reference
from fspt_tpu_torch.scene.schema import scene_to_torch
from fspt_tpu_torch.scripts.traverse5_proto import packet_traverse5_reference
from fspt_tpu_torch.testing import make_test_scene

torch.set_num_threads(1)

BENCH_ROWS = 4164 + 14138          # node + leaf rows of the 82k-triangle scene


def test_operation_counts():
    assert (SLAB_OPS, TRI_OPS) == (20, 55)


def test_per_ray_launch_is_bound_by_bytes():
    """350,208 lanes at 2.8 visits a ray over the 9.4 MB tables: 7 ray
    planes in, 5 hit planes out, the whole table once; 4.4 valid children a
    node visit and 5.79 real triangles a leaf visit."""
    b = traversal_bound(350_208, 8, 8, BENCH_ROWS, 600_000, 380_582,
                        child_tests=2_640_000, tri_tests=2_203_570)
    assert b["bytes"] == 350_208 * 48 + BENCH_ROWS * 512 == 26_180_608
    assert b["flops"] == 2_640_000 * 20 + 2_203_570 * 55 == 173_996_350
    assert b["bytes_ms"] == pytest.approx(26_180_608 / 3.35e9, rel=1e-12)
    assert b["bound_ms"] == pytest.approx(0.0078151, rel=1e-4)
    assert b["flops_ms"] == pytest.approx(0.0025970, rel=1e-4)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["bytes_ms"]


def test_group_walk_launch_is_bound_by_operations():
    """524,288 lanes = 4,096 groups of 128 at 67.1 visits a group: every
    lane does every group visit's arithmetic, on 4.4 children a node visit
    and 5.79 triangles a leaf visit."""
    node, leaf = 150_000, 124_842                       # group visits
    b = traversal_bound(524_288, 8, 8, BENCH_ROWS, node * 128, leaf * 128,
                        child_tests=660_000 * 128, tri_tests=722_835 * 128,
                        group=128)
    assert b["flops"] == 128 * (660_000 * 20 + 722_835 * 55) == 6_778_358_400
    assert b["bytes"] == 524_288 * 48 + BENCH_ROWS * 512 == 34_536_448
    assert b["bound_ms"] == pytest.approx(0.101170, rel=1e-4)
    assert b["bytes_ms"] == pytest.approx(0.0103094, rel=1e-4)
    assert b["bound_by"] == "operations" and b["bound_ms"] == b["flops_ms"]


def test_every_slot_counts_where_no_tally_is_given():
    """Without the tested children and triangles the bound takes every slot
    of every visited row: the most the launch could need."""
    node, leaf = 150_000 * 128, 124_842 * 128
    b = traversal_bound(524_288, 8, 8, BENCH_ROWS, node, leaf, group=128)
    assert b["flops"] == 128 * (150_000 * 160 + 124_842 * 440) \
        == 10_103_101_440
    assert b["bound_ms"] == pytest.approx(0.150793, rel=1e-4)
    full = traversal_bound(524_288, 8, 8, BENCH_ROWS, node, leaf, group=128,
                           child_tests=node * 8, tri_tests=leaf * 8)
    assert full == b


@pytest.mark.parametrize("case,kw,nbytes,flops", [
    # 5 fetches touch at most 5 rows of a larger table
    ("few_fetches", dict(lanes=8, tree_width=8, leaf_size=8, table_rows=100,
                         node_visits=3, leaf_visits=2),
     8 * 48 + 5 * 512, 3 * 160 + 2 * 440),
    # a group's lanes share a fetch: 256 lane visits of 128-lane groups = 2
    ("group_fetches", dict(lanes=128, tree_width=8, leaf_size=8,
                           table_rows=100, node_visits=128, leaf_visits=128,
                           group=128),
     128 * 48 + 2 * 512, 128 * 160 + 128 * 440),
    # 16-wide nodes, 4-triangle leaves, a partial group rounds up
    ("width16", dict(lanes=100, tree_width=16, leaf_size=4, table_rows=9,
                     node_visits=300, leaf_visits=100, group=128),
     100 * 48 + 4 * 512, 300 * 320 + 100 * 220),
    # the tested children and triangles replace the slot counts
    ("tally", dict(lanes=8, tree_width=8, leaf_size=8, table_rows=100,
                   node_visits=3, leaf_visits=2, child_tests=7, tri_tests=9),
     8 * 48 + 5 * 512, 7 * 20 + 9 * 55),
    # other plane counts: 6 in, 1 out (the micro study)
    ("planes", dict(lanes=1024, tree_width=8, leaf_size=8, table_rows=50,
                    node_visits=0, leaf_visits=0, in_planes=6, out_planes=1),
     1024 * 28, 0),
])
def test_bound_by_hand(case, kw, nbytes, flops):
    b = traversal_bound(**kw)
    assert (b["bytes"], b["flops"]) == (nbytes, flops)
    assert b["bytes_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert b["flops_ms"] == pytest.approx(flops / 67e12 * 1e3, rel=1e-12)
    assert b["bound_ms"] == max(b["bytes_ms"], b["flops_ms"])
    assert b["bound_by"] == ("bytes" if b["bytes_ms"] >= b["flops_ms"]
                             else "operations")


@pytest.fixture(scope="module")
def primary():
    """The 32x32 primary rays of the test scene, and its tables."""
    scene = make_test_scene(subdivisions=2)
    a = scene_to_torch(scene.arrays, "cpu")
    cam = scene.camera
    o, d = generate_rays(torch.tensor(cam.position),
                         torch.tensor(cam.direction), cam.fov_scale,
                         cam.focal_depth, cam.aperture, (32, 32),
                         stream_uniforms(key(0), 0, (4, 32 * 32)))
    kw = dict(leaf_size=scene.meta.leaf_size,
              stack_depth=scene.meta.pk_stack_depth + 16)
    return (a.pk_nodes, a.pk_leaves, o, d), kw


@pytest.mark.parametrize("name,ref,group", [
    ("traverse4", packet_traverse4_reference, 1),
    ("walk3", packet_traverse3_reference, 128),
    ("walk1", packet_traverse_reference, 1024),
    ("walk5", packet_traverse5_reference, 128),
])
def test_visit_split_sums_to_visits(primary, name, ref, group):
    args, kw = primary
    counts = {}
    hit = ref(*args, **kw, counts=counts)
    node, leaf = int(counts["node"]), int(counts["leaf"])
    assert node > 0 and leaf > 0
    assert (hit.slot >= 0).float().mean() > 0.3
    # one count per ray, or one per group held by each of its lanes
    assert node + leaf == int(hit.visits[::group].sum()) * group
    # the tally changes nothing
    plain = ref(*args, **kw)
    for f in hit._fields:
        assert torch.equal(getattr(hit, f), getattr(plain, f)), f
    # and it feeds the bound: no more than every slot of every visit
    children, tris = int(counts["children"]), int(counts["triangles"])
    assert 0 < children <= node * 8 and 0 < tris <= leaf * kw["leaf_size"]
    rows = args[0].shape[0] + args[1].shape[0]
    b = traversal_bound(hit.t.numel(), 8, kw["leaf_size"], rows, node, leaf,
                        child_tests=children, tri_tests=tris, group=group)
    assert b["flops"] == children * 20 + tris * 55
    assert b["bound_ms"] > 0


def test_row_counts_by_hand():
    """Valid children and real triangles of hand-made rows."""
    node = torch.zeros(2, 128)
    node[0, 48:56] = torch.tensor([3, -5, 7, -1e9, -1e9, -1e9, -1e9, -1e9])
    node[1, 48:56] = -1e9
    assert valid_children(node, 8).tolist() == [3, 0]
    wide = torch.full((1, 128), -1e9)
    wide[0, 96:107] = 1.0                        # 16-wide: links at 96..111
    assert valid_children(wide, 16).tolist() == [11]
    leaf = torch.zeros(2, 128)
    leaf[0, 0:9] = 1.0                           # slot 0: a triangle
    leaf[0, 18:21] = 2.0                         # slot 2: a corner, no edge
    leaf[0, 9 * 5 + 7] = -0.5                    # slot 5: one edge component
    assert real_triangles(leaf, 8).tolist() == [2, 0]
    counts = {}
    tally_visits(counts, "node", node, 128, 8)
    tally_visits(counts, "leaf", leaf, 128, 8)
    assert counts == {"node": 256, "children": 384, "leaf": 256,
                      "triangles": 256}


def test_tested_children_match_an_independent_recount(primary):
    """traverse4 walks each ray alone, so the tally of a launch must be the
    sum of the tallies of its rays launched one at a time."""
    args, kw = primary
    nodes, leaves, o, d = args
    whole = {}
    packet_traverse4_reference(*args, **kw, counts=whole)
    parts = {}
    idx = torch.arange(0, o.x.numel(), 37)
    for i in idx.tolist():
        one = lambda v: type(v)(*(x[i:i + 1] for x in v))
        packet_traverse4_reference(nodes, leaves, one(o), one(d), **kw,
                                   counts=parts)
    sub = {}
    pick = lambda v: type(v)(*(x[idx] for x in v))
    packet_traverse4_reference(nodes, leaves, pick(o), pick(d), **kw,
                               counts=sub)
    assert {k: int(v) for k, v in parts.items()} \
        == {k: int(v) for k, v in sub.items()}
    assert all(int(sub[k]) < int(whole[k]) for k in sub)
