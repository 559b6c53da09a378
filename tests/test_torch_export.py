"""The deployable artifact (``inference.py``: ``ClipInferenceEngine.export``,
``load_exported``, ``load_exported_sharded``) against the engine, the JAX
engine and the JAX artifact (CPU, tiny models built with
``attn_impl="fused"`` so that the kernel op is in every graph).

* One process: one ``.pt2`` per (encoder, bucket) under the JAX package's
  names and keys; each reloaded program equals ``engine.encode_*`` within
  1e-6 (the same ops on the same weights) and the JAX engine's features and
  the JAX artifact's output (``tpu/inference.py:export`` and
  ``load_exported``) within 1e-4, the tolerance of
  ``tests/test_torch_serve.py`` (fp32 summation order); a tiny SigLIP, whose
  MAP head calls the op with one query; an int8 engine, whose program holds
  the int8 values (file bytes well under fp32's) and equals the int8 engine
  within 1e-6 and the JAX int8 engine within 1e-5
  (``tests/test_torch_int8.py``); a reload in a fresh interpreter that
  builds no model; no CPU run of an artifact traced on a card.
* A mesh, over two gloo ranks (``tests/torch_dist_utils.py``, one spawn for
  every case) at ``(1, 2)`` and ``(2, 1)``: ``params.npz`` and the manifest,
  programs that hold no weights, features within 1e-5 of the one-process
  engine's (``tests/test_torch_tp_serve.py``), ``ValueError`` on another
  mesh, a re-export of changed weights to the same directory served anew,
  a bf16 engine's tensors back bit for bit, and a load onto a mesh whose
  model group has another name than at export (the graph's collectives
  rebound to it).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.inference import (
    ClipInferenceEngine, load_exported,
)

from .torch_dist_utils import run_ranks
from .torch_port_utils import images, jax_clip, port_clip, token_ids

CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 16, "patch_size": 8, "width": 64, "layers": 2,
                   "head_width": 32},
    "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 64, "heads": 4,
                 "layers": 2},
}
BUCKETS = (1, 2)
JAX_TOL = 1e-4
FUSED = torch.ops.rcd_torch.fused_attention_fwd.default
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(name: str, size=16, ctx=12, seed=0):
    """A batch of the bucket ``name`` ends with, in the artifact's layout."""
    b = int(name.rsplit("_b", 1)[1])
    return images(b, size, seed=seed) if "image" in name else token_ids(b, ctx, seed=seed)


def _engine_call(engine, name, x):
    return (engine.encode_image if "image" in name else engine.encode_text)(x)


def _fused_calls(program):
    return [n for n in program.graph.nodes if n.op == "call_function" and n.target == FUSED]


@pytest.fixture(scope="module", autouse=True)
def sharded_ranks(tmp_path_factory):
    """The two gloo ranks of the mesh cases, started with the module's first
    test and run beside the one-process tests."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, _sharded_ranks, 2, str(tmp_path_factory.mktemp("sharded")))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    jmodel, variables = jax_clip(CFG, attn_impl="xla", seed=21, jit=True)
    engine = ClipInferenceEngine(port_clip(CFG, variables["params"], attn_impl="fused"),
                                 (16, 16), 12, buckets=BUCKETS)
    out = tmp_path_factory.mktemp("artifact")
    return {"jax": (jmodel, variables), "engine": engine, "written": engine.export(str(out)),
            "dir": str(out)}


def test_export_writes_a_program_per_encoder_and_bucket(artifact):
    written = artifact["written"]
    assert sorted(written) == ["encode_image_b1", "encode_image_b2", "encode_text_b1",
                               "encode_text_b2"]
    for key, path in written.items():
        assert path == os.path.join(artifact["dir"], f"{key}.pt2") and os.path.getsize(path)
    assert sorted(os.listdir(artifact["dir"])) == sorted(f"{k}.pt2" for k in written)


@pytest.mark.parametrize("name", ["encode_image_b1", "encode_image_b2", "encode_text_b1",
                                  "encode_text_b2"])
def test_each_program_equals_the_engine(artifact, name):
    run = load_exported(artifact["written"][name])
    x = _batch(name, seed=3)
    got = run(x)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), _engine_call(artifact["engine"], name, x),
                               atol=1e-6, rtol=0)
    assert len(_fused_calls(run.program)) == 2  # one a layer
    assert torch.equal(run(torch.from_numpy(x)), got)  # a tensor in, as an array
    # no traced asserts, no cast to the dtype a tensor has (eager returns it)
    calls = [n for n in run.program.graph.nodes if n.op == "call_function"]
    assert not [n for n in calls if n.target is torch.ops.aten._assert_tensor_metadata.default]
    assert not [n for n in calls if n.target is torch.ops.aten.to.dtype
                and n.args[0].meta["val"].dtype == n.args[1]]


def test_programs_match_the_jax_engine_and_the_jax_artifact(artifact, tmp_path):
    from refining_clip_via_dinov2_representations_tpu.inference import (
        ClipInferenceEngine as JaxEngine, load_exported as jax_load_exported,
    )

    jax_engine = JaxEngine(*artifact["jax"], image_size=(16, 16), context_length=12,
                           buckets=(2,))
    jax_written = jax_engine.export(str(tmp_path))
    for name in ("encode_image_b2", "encode_text_b2"):
        x = _batch(name, seed=4)
        got = load_exported(artifact["written"][name])(x).numpy()
        np.testing.assert_allclose(got, _engine_call(jax_engine, name, x), atol=JAX_TOL,
                                   rtol=0)
        np.testing.assert_allclose(got, np.asarray(jax_load_exported(jax_written[name])(x)),
                                   atol=JAX_TOL, rtol=0)


def test_siglip_program_runs_the_map_head_through_the_op(tmp_path, monkeypatch):
    from refining_clip_via_dinov2_representations_torch.models import siglip as tsiglip
    from refining_clip_via_dinov2_representations_tpu.inference import (
        ClipInferenceEngine as JaxEngine,
    )
    from refining_clip_via_dinov2_representations_tpu.models import siglip as jsiglip

    from .test_torch_siglip import TINY_DIMS, _jax_siglip, _port_from_jax_exporter

    monkeypatch.setitem(jsiglip._SIGLIP_FAMILY_DIMS, "base", TINY_DIMS)
    monkeypatch.setitem(tsiglip._SIGLIP_FAMILY_DIMS, "base", TINY_DIMS)
    jmodel, variables = _jax_siglip(seed=5)
    engine = ClipInferenceEngine(_port_from_jax_exporter(variables["params"]).eval(),
                                 (32, 32), 16, buckets=(2,))
    run = load_exported(engine.export(str(tmp_path))["encode_image_b2"])
    x = images(2, 32, seed=6)
    got = run(x).numpy()
    np.testing.assert_allclose(got, engine.encode_image(x), atol=1e-6, rtol=0)
    jax_engine = JaxEngine(jmodel, variables, image_size=(32, 32), context_length=16,
                           buckets=(2,))
    np.testing.assert_allclose(got, jax_engine.encode_image(x), atol=JAX_TOL, rtol=0)
    queries = [n.args[0].meta["val"].shape[2] for n in _fused_calls(run.program)]
    assert queries == [16, 16, 1]  # two trunk blocks over the 16 patches, the head's probe


def test_int8_program_holds_int8_values_and_matches_both_int8_engines(tmp_path):
    from refining_clip_via_dinov2_representations_tpu.inference import (
        ClipInferenceEngine as JaxEngine,
    )

    min_size = 512
    jmodel, variables = jax_clip(CFG, attn_impl="xla", seed=7, noise=0.05, jit=True)
    jax_int8 = JaxEngine(jmodel, variables, (16, 16), 12, buckets=(2,), quantize="int8",
                         quantize_min_size=min_size)
    sizes, outs = {}, {}
    x, ids = images(2, 16, seed=8), token_ids(2, 12, seed=9)
    for mode in (None, "int8"):
        engine = ClipInferenceEngine(port_clip(CFG, variables["params"], attn_impl="fused"),
                                     (16, 16), 12, buckets=(2,), quantize=mode,
                                     quantize_min_size=min_size)
        written = engine.export(str(tmp_path / str(mode)))
        program = torch.export.load(written["encode_image_b2"])
        sizes[mode] = (os.path.getsize(written["encode_image_b2"]),
                       sum(t.numel() * t.element_size() for t in program.constants.values()))
        outs[mode] = {name: load_exported(written[name])(arg).numpy()
                      for name, arg in (("encode_image_b2", x), ("encode_text_b2", ids))}
        if mode == "int8":
            vision_q = sum(p.numel() for n, p in engine.model.named_parameters()
                           if n.startswith("visual.") and p.dtype == torch.int8)
            stored = sum(t.numel() for t in program.constants.values()
                         if t.dtype == torch.int8)
            np.testing.assert_allclose(outs[mode]["encode_image_b2"], engine.encode_image(x),
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(outs[mode]["encode_text_b2"], engine.encode_text(ids),
                                       atol=1e-6, rtol=0)
    assert stored == vision_q > 0  # each int8 tensor once
    # the tower's tensors: each quantized value 1 byte, not 4 (the file also
    # holds the graph, a larger share at these widths)
    assert sizes["int8"][1] < 0.35 * sizes[None][1] and sizes["int8"][0] < 0.7 * sizes[None][0]
    np.testing.assert_allclose(outs["int8"]["encode_image_b2"], jax_int8.encode_image(x),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(outs["int8"]["encode_text_b2"], jax_int8.encode_text(ids),
                               atol=1e-5, rtol=0)
    assert np.abs(outs["int8"]["encode_image_b2"] - outs[None]["encode_image_b2"]).max() > 1e-6


_FRESH = """
import sys
import numpy as np
import torch
built = []
init = torch.nn.Module.__init__
def spy(self, *a, **k):
    built.append(type(self).__module__)
    init(self, *a, **k)
torch.nn.Module.__init__ = spy
from refining_clip_via_dinov2_representations_torch import load_exported
got = load_exported(sys.argv[1])(np.load(sys.argv[2])).numpy()
np.save(sys.argv[3], got)
models = [m for m in built if m.startswith("refining_clip_via_dinov2_representations_torch")]
print("MODULES", models)
"""


def test_reload_in_a_fresh_interpreter_builds_no_model(artifact, tmp_path):
    x = _batch("encode_text_b2", seed=10)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _FRESH, artifact["written"]["encode_text_b2"],
                           str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
                          capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "MODULES []" in proc.stdout, proc.stdout
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"),
                               artifact["engine"].encode_text(x), atol=1e-6, rtol=0)


def test_a_program_traced_on_a_card_does_not_run_on_the_cpu(artifact, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    from refining_clip_via_dinov2_representations_torch.inference import _META_FILE

    exported = torch.export.load(artifact["written"]["encode_text_b1"])
    path = tmp_path / "card.pt2"
    meta = {"device": "cuda:0", "allow_tf32": {"matmul": False, "cudnn": False}}
    torch.export.save(exported, str(path), extra_files={_META_FILE: json.dumps(meta)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(str(path))


# ------------------------------------------------------------------ a mesh

def _remeshed(model_axis: int):
    """The ``(data, model)`` mesh over two ranks on groups made anew, so its
    model group's name is not the one ``create_mesh`` gave at export."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    rank, data = dist.get_rank(), 2 // model_axis
    rows = [[r * model_axis + j for j in range(model_axis)] for r in range(data)]
    cols = [[r * model_axis + j for r in range(data)] for j in range(model_axis)]
    groups = {}
    for axis, sets in (("data", cols), ("model", rows)):
        for ranks in sets:
            g = dist.new_group(ranks, backend="gloo")
            if rank in ranks:
                groups[axis] = g
    return DeviceMesh.from_group([groups["data"], groups["model"]], "cpu", mesh=rows,
                                 mesh_dim_names=("data", "model"))


def _mesh_case(out_dir, model_axis, seed, dtype=torch.float32):
    """Rank 0's one-process engine and every rank's mesh engine on the same
    seeded weights, the mesh engine exported to ``out_dir``."""
    import copy

    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import create_mesh

    base = build_model(parse_model_cfg(CFG), attn_impl="fused", seed=seed).to(dtype)
    one = ClipInferenceEngine(copy.deepcopy(base), (16, 16), 12, buckets=BUCKETS)
    mesh = create_mesh(model=model_axis, device_type="cpu")
    eng = ClipInferenceEngine(base, (16, 16), 12, buckets=BUCKETS, mesh=mesh)
    return one, eng, eng.export(out_dir)


def _served(out_dir, mesh, one):
    """{name: max |artifact - one process|} over every program."""
    from refining_clip_via_dinov2_representations_torch.inference import load_exported_sharded

    errs = {}
    for name in sorted(f[:-4] for f in os.listdir(out_dir) if f.endswith(".pt2")):
        x = _batch(name, seed=int(name[-1]))
        got = load_exported_sharded(out_dir, name, mesh)(x).numpy()
        errs[name] = float(np.abs(got - _engine_call(one, name, x)).max())
    return errs


def _sharded_ranks(rank, world, root):
    from refining_clip_via_dinov2_representations_torch.inference import (
        _SHARDED_PARAMS_CACHE, _bind_collectives, _load_sharded_params, load_exported_sharded,
    )

    out = {}
    for model_axis in (2, 1):
        d = os.path.join(root, f"mesh_1x{model_axis}" if model_axis == 2 else "mesh_2x1")
        one, eng, written = _mesh_case(d, model_axis, seed=31)
        mesh = _remeshed(model_axis)
        res = {"written": sorted(written), "buckets": eng.buckets, "errs": _served(d, mesh, one)}
        run = load_exported_sharded(d, f"encode_text_b{eng.buckets[-1]}", mesh)
        res["graph_groups"] = sorted({str(a) for n in run.program.graph.nodes
                                      if getattr(n.target, "namespace", "") == "_c10d_functional"
                                      for a in n.args if isinstance(a, str) and a.isdigit()})
        res["mesh_group"] = mesh["model"].get_group().group_name
        res["fused"] = len(_fused_calls(run.program))
        with open(written["manifest"]) as f:
            manifest = json.load(f)
        res["manifest"] = {k: manifest[k] for k in ("mesh_axes", "batch_spec", "model_group")}
        res["splits"] = sum(p["split"] is not None for p in manifest["params"])
        programs = [torch.export.load(written[k]) for k in written if k.startswith("encode")]
        res["program_tensors"] = sum(len(p.state_dict) + len(p.constants) for p in programs)
        res["bytes"] = {k: os.path.getsize(p) for k, p in written.items()}
        out[model_axis] = res
        if model_axis == 2:
            try:  # a collective of a group the artifact does not name
                _bind_collectives(run.program, "no such group", _remeshed(2)["model"].get_group())
            except ValueError as e:
                out["unbound"] = str(e)
            other = _remeshed(1)
            try:
                load_exported_sharded(d, "encode_image_b2", other)
            except ValueError as e:
                out["mismatch"] = str(e)
            # changed weights to the same directory: the cache misses, the new ones serve
            one2, _, _ = _mesh_case(d, model_axis, seed=32)
            out["reexport"] = {"errs": _served(d, mesh, one2), "entries": sum(
                k[0] == os.path.abspath(d) for k in _SHARDED_PARAMS_CACHE)}
    one, eng, written = _mesh_case(os.path.join(root, "bf16"), 2, seed=33, dtype=torch.bfloat16)
    _, loaded = _load_sharded_params(os.path.join(root, "bf16"), _remeshed(2), "cpu")
    local = list(eng.model.named_parameters()) + list(eng.model.named_buffers())
    out["bf16"] = {"n": len(local), "equal": len(loaded) == len(local) and all(
        t.dtype == w.dtype and torch.equal(t.view(torch.int16) if t.dtype == torch.bfloat16 else t,
                                           w.detach().view(torch.int16)
                                           if w.dtype == torch.bfloat16 else w.detach())
        for t, (_, w) in zip(loaded, local)),
        "dtypes": sorted({str(w.dtype) for _, w in local})}
    return out


@pytest.fixture(scope="module")
def sharded(sharded_ranks):
    return sharded_ranks.result()


@pytest.mark.parametrize("model_axis", [2, 1])
def test_sharded_artifact_matches_the_one_process_engine(sharded, model_axis):
    r0, r1 = (r[model_axis] for r in sharded)
    names = [f"encode_{op}_b{b}" for b in r0["buckets"] for op in ("image", "text")]
    assert r0["written"] == sorted(names + ["manifest", "params"])
    assert r0["buckets"] == ((1, 2) if model_axis == 2 else (2,))
    for r in (r0, r1):
        assert sorted(r["errs"]) == sorted(names) and max(r["errs"].values()) <= 1e-5, r["errs"]
        assert r["fused"] == 2
    assert r0["manifest"]["mesh_axes"] == {"data": 2 // model_axis, "model": model_axis}
    assert r0["manifest"]["batch_spec"] == ["data"]
    assert (r0["splits"] > 0) == (model_axis == 2)


def test_sharded_programs_hold_no_weights(sharded):
    for model_axis in (2, 1):
        r = sharded[0][model_axis]
        assert r["program_tensors"] == 0
        programs = [v for k, v in r["bytes"].items() if k.startswith("encode")]
        assert max(programs) < r["bytes"]["params"] / 10, r["bytes"]


def test_collectives_are_rebound_to_the_loading_mesh(sharded):
    for r in sharded:
        got = r[2]
        assert got["mesh_group"] != got["manifest"]["model_group"]
        assert got["graph_groups"] == [got["mesh_group"]]
        assert "not the model group the artifact was exported with" in r["unbound"]


def test_another_mesh_raises_and_a_reexport_serves_the_new_weights(sharded):
    assert "mesh mismatch" in sharded[0]["mismatch"] and "{'data': 1, 'model': 2}" in \
        sharded[0]["mismatch"]
    for r in sharded:
        assert max(r["reexport"]["errs"].values()) <= 1e-5, r["reexport"]
        assert r["reexport"]["entries"] == 1  # the older version's copy dropped


def test_bf16_tensors_come_back_bit_for_bit(sharded):
    for r in sharded:
        assert r["bf16"]["equal"] and r["bf16"]["n"] > 0
        assert "torch.bfloat16" in r["bf16"]["dtypes"]
