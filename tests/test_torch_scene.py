"""Port parity: the numpy scene layer carried into the PyTorch port compiles
every library scene and every saved map to the JAX package's exact param
vector and SceneSpec structure, and scenes cross between the packages
through the shared JSON format."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from compute_path_tracer_tpu.render.scenegen import (
    material_slot_matrix as j_slots,
)
from compute_path_tracer_tpu.scene import compile_scene as j_compile
from compute_path_tracer_tpu.scene import library as j_lib
from compute_path_tracer_tpu.scene import load_scene as j_load
from compute_path_tracer_tpu.scene.model import Scene as JScene
from compute_path_tracer_tpu_torch.render.scenegen import (
    material_slot_matrix as t_slots,
)
from compute_path_tracer_tpu_torch.scene import (
    compile_scene as t_compile,
    convert_scene,
    library as t_lib,
    load_scene as t_load,
    params_from_numpy,
)

SCENES = ["sphere_and_plane", "csg_demo", "blend_demo", "glass_demo",
          "edge_demo", "benchmark_scene"]
MAPS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "data",
                                     "maps", "*.json")))


def _same_compile(jc, tc):
    assert tc.params.dtype == np.float32
    assert np.array_equal(np.asarray(jc.params).view(np.uint32),
                          tc.params.view(np.uint32))
    # Same dataclass names and fields on both sides, so the reprs compare
    # the whole structure.
    assert repr(tc.spec) == repr(jc.spec)


@pytest.mark.parametrize("name", SCENES)
def test_library_scene_compiles_identically(name):
    jc = j_compile(getattr(j_lib, name)())
    tc = t_compile(getattr(t_lib, name)())
    _same_compile(jc, tc)
    assert np.array_equal(t_slots(tc.spec), j_slots(jc.spec))


@pytest.mark.parametrize("path", MAPS, ids=os.path.basename)
def test_saved_map_compiles_identically(path):
    jc, tc = j_compile(j_load(path)), t_compile(t_load(path))
    _same_compile(jc, tc)
    assert np.array_equal(t_slots(tc.spec), j_slots(jc.spec))


@pytest.mark.parametrize("name", SCENES)
def test_json_port_to_jax(name):
    scene = getattr(t_lib, name)()
    back = JScene.from_dict(json.loads(json.dumps(scene.to_dict())))
    _same_compile(j_compile(back), t_compile(scene))


@pytest.mark.parametrize("name", SCENES)
def test_json_jax_to_port(name):
    scene = getattr(j_lib, name)()
    _same_compile(j_compile(scene), t_compile(convert_scene(scene)))


def test_params_from_numpy():
    cs = t_compile(t_lib.sphere_and_plane())
    p = params_from_numpy(cs.params, cs.spec, "cpu")
    assert p.dtype == torch.float32 and torch.equal(p, torch.from_numpy(cs.params))
    with pytest.raises(ValueError):
        params_from_numpy(cs.params[:-1], cs.spec, "cpu")
    with pytest.raises(TypeError):
        params_from_numpy(cs.params.astype(np.float64), cs.spec, "cpu")
