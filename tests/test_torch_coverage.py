"""The port's claim of completeness, as a test.

Every module of ``lidar_slam_tpu/`` is parsed with ``ast`` (nothing is
imported). Each public top-level ``def``/``class``, and each public method
of ``SlamEngine`` and ``BatchedSlamEngine``, must have a counterpart of the
same name in the port's module of the same path (or the module ``MODULES``
maps it to), a counterpart of another name in ``RENAMED``, or a reason in
``LEFT_OUT``: the TPU workaround it is, or where the port does its work
instead. The engines' public methods must also take every parameter the JAX
ones take.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "lidar_slam_tpu"
PORT_PKG = ROOT / "lidar_slam_tpu_torch"

# JAX module -> the port's module of another path
MODULES = {"ops/knn_pallas.py": "ops/knn_cuda.py"}

ENGINES = {"models/pipeline.py": "SlamEngine",
           "parallel/batched.py": "BatchedSlamEngine"}

# "module:name" (or "module:Class.method") -> the port's "module:name"
RENAMED = {
    "ops/knn_pallas.py:nn1_pallas": "ops/knn_cuda.py:nn1",
    "ops/knn_pallas.py:nn1_slab_pallas": "ops/knn_cuda.py:nn1_slab",
    "ops/knn_pallas.py:match_slab_pallas": "ops/knn_cuda.py:match_slab",
    "ops/knn_pallas.py:make_slab_pallas_backend": "ops/knn_cuda.py:SlabBackend",
    "models/pipeline.py:make_init_fn": "models/pipeline.py:init_frame",
    "models/pipeline.py:make_step_fn": "models/pipeline.py:step",
    "models/pipeline.py:make_loop_fn": "models/pipeline.py:loop_tick",
    "models/pipeline.py:make_optimize_fn": "parallel/batched.py:optimize_chunk",
    "models/pipeline.py:make_finalize_fn": "models/pipeline.py:rebuild_occupancy",
    "parallel/batched.py:stack_states": "models/pipeline.py:stack_states",
    "parallel/batched.py:make_gated_optimize": "parallel/batched.py:gated_optimize",
    "parallel/batched.py:BatchedSlamEngine.pad_scans_np":
        "parallel/batched.py:BatchedSlamEngine.pad_scans",
}

_DISPATCH = ("a TPU dispatch workaround: the port runs each scan and each "
             "cadence tick in turn (SlamEngine.push_scan / run_preloaded, "
             "models/pipeline.step and loop_tick), which gives the state "
             "these programs give")
_DF64 = ("the emulated float64 (double-single) arithmetic of the TPU's "
         "precision tier; the port has native float64 on the card "
         "(pose_graph.optimize on a float64 state)")

# "module:name", or "module" for the whole module -> why the port has none
LEFT_OUT = {
    "ops/df64.py": _DF64,
    "ops/knn_pallas.py:pallas_supported":
        "a probe of the Pallas TPU backend; the port picks the kernel or its "
        "plain version from the tensor's device (cuda_lib.use_kernel)",
    "ops/grid_nn.py:make_grid_corr_fn":
        "make_grid_backend(cell).prepare(tgt, mask) returns the same "
        "prepared-grid closure",
    "models/loop_closure.py:subsample_idx":
        "an alias of types.strided_prefix_idx, which the port calls",
    "models/loop_closure.py:subsample":
        "an alias of PointCloud.subsample, which the port calls",
    "models/pipeline.py:make_block_step_fn": _DISPATCH,
    "models/pipeline.py:make_resident_block_fn": _DISPATCH,
    "models/pipeline.py:make_loop_fn_split": _DISPATCH,
    "models/pipeline.py:make_multi_tick_fn": _DISPATCH,
    "models/pipeline.py:enable_compilation_cache":
        "the persistent XLA compilation cache; the port compiles nothing "
        "but its kernels, which knn_cuda caches by source hash",
    "models/pose_graph.py:optimize_dd": _DF64,
    "models/pose_graph.py:dd_backend_healthy":
        "the self-test that gates the emulated-f64 tier; " + _DF64,
    "models/pose_graph.py:reset_dd_health":
        "resets that self-test; " + _DF64,
    "models/pose_graph.py:optimize_host":
        "the NumPy float64 Woodbury LM; the port runs pose_graph.optimize "
        "on a float64 state on the card (pipeline.finalize_state, and the "
        "backstop of pose_graph.optimize_chunked)",
    "utils/native.py:native_available":
        "the JAX CLI's choice between the native library and NumPy; the "
        "port builds its own native library and has no NumPy fallback "
        "(utils/native.get_lib)",
}


def _modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _tree(path: Path):
    return ast.parse(path.read_text()) if path.exists() else ast.Module(body=[])


def _bound(tree) -> dict:
    """Top-level names of a module -> their nodes: defs, classes,
    assignments and imports."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update({t.id: node for t in targets if isinstance(t, ast.Name)})
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update({(a.asname or a.name).split(".")[0]: node
                        for a in node.names})
    return out


def _methods(cls: ast.ClassDef) -> dict:
    return {m.name: m for m in cls.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _public(tree) -> list:
    """``name`` for each public top-level def/class, ``Class.method`` for
    each public method of the engine classes."""
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            names.append(node.name)
            if isinstance(node, ast.ClassDef) and node.name in ENGINES.values():
                names += [f"{node.name}.{m}" for m in _methods(node)
                          if not m.startswith("_")]
    return names


def _lookup(ref: str):
    """The port's node for ``"module:name"`` or ``"module:Class.method"``."""
    mod, _, name = ref.partition(":")
    bound = _bound(_tree(PORT_PKG / mod))
    cls, _, meth = name.partition(".")
    node = bound.get(cls)
    if meth:
        return _methods(node).get(meth) if isinstance(node, ast.ClassDef) else None
    return node


def _counterpart(mod: str, name: str):
    key = f"{mod}:{name}"
    if key in RENAMED:
        return _lookup(RENAMED[key])
    return _lookup(f"{MODULES.get(mod, mod)}:{name}")


@pytest.mark.parametrize("mod", _modules())
def test_every_public_name_is_ported_or_left_out(mod):
    missing = []
    for name in _public(_tree(JAX_PKG / mod)):
        if mod in LEFT_OUT or f"{mod}:{name}" in LEFT_OUT:
            continue
        if _counterpart(mod, name) is None:
            missing.append(name)
    assert not missing, (
        f"{mod}: no counterpart in the port and no reason in LEFT_OUT: {missing}")


def test_maps_name_real_names():
    """Every key of ``RENAMED`` and ``LEFT_OUT`` names a public name (or a
    module) of the JAX package, every ``RENAMED`` target exists, no reason
    is empty, and no name is left out that the port has after all."""
    public = {mod: _public(_tree(JAX_PKG / mod)) for mod in _modules()}
    for key, reason in LEFT_OUT.items():
        mod, _, name = key.partition(":")
        assert mod in public and (not name or name in public[mod]), key
        assert reason.strip(), key
        if name:
            assert _lookup(f"{MODULES.get(mod, mod)}:{name}") is None, (
                f"{key} is in LEFT_OUT but the port has it")
    for key, target in RENAMED.items():
        mod, _, name = key.partition(":")
        assert name in public[mod], key
        assert _lookup(target) is not None, (key, target)
        assert key not in LEFT_OUT


@pytest.mark.parametrize("mod,cls", sorted(ENGINES.items()))
def test_engine_methods_take_the_jax_parameters(mod, cls):
    """Each public method (and ``__init__``) of the port's engine takes
    every parameter of the JAX engine's method of that name, so a call
    written for one engine runs on the other (the port adds ``device`` and
    its own options)."""
    jcls = _bound(_tree(JAX_PKG / mod))[cls]
    pcls = _bound(_tree(PORT_PKG / mod))[cls]
    pm = _methods(pcls)
    short = {}
    for name, node in _methods(jcls).items():
        if name.startswith("_") and name != "__init__":
            continue
        key = f"{mod}:{cls}.{name}"
        port = _lookup(RENAMED[key]) if key in RENAMED else pm.get(name)
        assert port is not None, key
        params = {a.arg for a in port.args.args + port.args.kwonlyargs}
        lack = [a.arg for a in node.args.args + node.args.kwonlyargs
                if a.arg not in params]
        if lack:
            short[name] = lack
    assert not short, f"{cls}: methods lack the JAX parameters {short}"
