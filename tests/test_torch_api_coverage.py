"""The port's public API, held to the JAX package's by their sources alone.

For every ``.py`` file of ``nvblox_mindmap_tpu/`` the file of the same path
under ``nvblox_mindmap_torch/`` must exist and define or import each public
top-level name of the JAX file (a function, a class or a constant; names
starting with ``_`` are private), list each entry of its ``__all__`` in its
own, and give each public function the JAX function's parameters by name.
For each public class it must have each public method, with the JAX
method's parameters, and each public class attribute.

Three rules translate flax to torch and are not exceptions: a flax
module's dataclass fields are the torch module's constructor parameters (or
attributes), its ``setup`` is the torch ``__init__`` and its ``__call__`` is
``forward``. A class's members are looked up through its bases in the same
file.

What the port leaves out is the table ``EXCEPTIONS``, one reason per entry,
each of one of the categories below; an entry that the port no longer needs
fails the test too. The test reads the sources with ``ast`` and imports
neither package.
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PACKAGE = os.path.join(ROOT, "nvblox_mindmap_tpu")
PORT_PACKAGE = os.path.join(ROOT, "nvblox_mindmap_torch")
FUNCTIONS = (ast.FunctionDef, ast.AsyncFunctionDef)
FLAX_TO_TORCH = {"__call__": "forward"}

# The categories of what the port leaves out.
FUNCTIONAL_STATE = "JAX's functional state"
PALLAS_TILING = "Pallas tiling"
XLA_ONLY = "XLA only"
JAX_SHARDING = "JAX sharding"
RENAMED = "another name"
UNSET_FLAG = "a flag no JAX caller sets"
CATEGORIES = (FUNCTIONAL_STATE, PALLAS_TILING, XLA_ONLY, JAX_SHARDING, RENAMED, UNSET_FLAG)

DROPOUT_MODE = ("flax passes the dropout mode to each call; a torch module keeps it "
                "(Module.train / eval)")
PARAMS = "flax passes the parameters to each call; the port's module or model holds them"
OPT_STATE = "optax's state is passed around; the port's Optimizer holds it"
TEMPLATE = ("flax restores into a template tree; the port loads into the model and "
            "optimizer it holds")
PRNG_KEY = ("a JAX PRNG key; the port draws from torch's generator or takes the noise "
            "(sampler_noise)")


def _entries(category, reasons):
    return {key: (category, reason) for key, reason in reasons.items()}


EXCEPTIONS = {
    **_entries(FUNCTIONAL_STATE, {
        "apps/run_open_loop_policy.py:run_inference(params)": PARAMS,
        "apps/run_open_loop_policy.py:run_inference(bounds)":
            "the infer function holds the bounds (make_infer_fn(model, bounds)); the JAX "
            "function never reads this argument",
        "apps/run_open_loop_policy.py:run_inference(key)":
            "a JAX PRNG key; the port takes the sample's seed",
        "closed_loop/policies.py:NvbloxDiffuserActorPolicy.__init__(params)": PARAMS,
        "models/diffuser_actor.py:DiffuserActor.encode(deterministic)": DROPOUT_MODE,
        "models/diffuser_actor.py:DiffuserActor.denoise(deterministic)": DROPOUT_MODE,
        "models/diffuser_actor.py:DiffuserActor.__call__(deterministic)": DROPOUT_MODE,
        "models/diffuser_actor.py:diffusion_train_loss(variables)": PARAMS,
        "models/diffuser_actor.py:diffusion_train_loss(rng)": PRNG_KEY,
        "models/diffuser_actor.py:diffusion_train_loss(deterministic)": DROPOUT_MODE,
        "models/diffuser_actor.py:sample_trajectory(variables)": PARAMS,
        "models/diffuser_actor.py:sample_trajectory(rng)": PRNG_KEY,
        "models/diffusion_head.py:Mlp.__call__(deterministic)": DROPOUT_MODE,
        "models/diffusion_head.py:DiffusionHead.__call__(deterministic)": DROPOUT_MODE,
        "models/encoder.py:Encoder.encode_gripper_history(deterministic)": DROPOUT_MODE,
        "models/encoder.py:Encoder.encode_goal_gripper(deterministic)": DROPOUT_MODE,
        "models/encoder.py:Encoder.vision_language_attention(deterministic)": DROPOUT_MODE,
        "models/layers.py:MultiheadAttention.__call__(deterministic)": DROPOUT_MODE,
        "models/layers.py:FeedforwardLayer.__call__(deterministic)": DROPOUT_MODE,
        "models/layers.py:RelativeCrossAttentionLayer.__call__(deterministic)": DROPOUT_MODE,
        "models/layers.py:FFWRelativeCrossAttentionModule.__call__(deterministic)":
            DROPOUT_MODE,
        "models/layers.py:FFWRelativeSelfAttentionModule.__call__(deterministic)":
            DROPOUT_MODE,
        "models/layers.py:FFWRelativeSelfCrossAttentionModule.__call__(deterministic)":
            DROPOUT_MODE,
        "models/layers.py:ParallelAttentionLayer.__call__(deterministic)": DROPOUT_MODE,
        "models/layers.py:ParallelAttention.__call__(deterministic)": DROPOUT_MODE,
        "ops/schedulers.py:DiffusionSchedule.step(key)": PRNG_KEY,
        "parallel/mesh.py:replicate(tree)":
            "JAX replicates a parameter tree; the port broadcasts a module's parameters",
        "scripts/place_grounding_probe.py:probe_scene(params)": PARAMS,
        "scripts/place_grounding_probe.py:probe_drill_pick_scene(params)": PARAMS,
        "scripts/place_grounding_probe.py:probe_stick_pick_scene(params)": PARAMS,
        "training/checkpoint.py:save_checkpoint_file(params)": PARAMS,
        "training/checkpoint.py:save_checkpoint_file(opt_state)": OPT_STATE,
        "training/checkpoint.py:load_checkpoint_file(params_template)": TEMPLATE,
        "training/checkpoint.py:load_checkpoint_file(opt_state_template)": TEMPLATE,
        "training/checkpoint.py:save_checkpoint(params)": PARAMS,
        "training/checkpoint.py:save_checkpoint(opt_state)": OPT_STATE,
        "training/optimizer.py:frozen_feature_extractor_mask(params)":
            "JAX masks a parameter tree; the port masks the model's named parameters",
        "training/trainer.py:Trainer.init_state(batch_template)":
            "flax traces a batch to create the parameters; the port's model has them",
        "training/trainer.py:Trainer.init_state(rng)": PRNG_KEY,
        "training/trainer.py:Trainer.train_one_step(params)": PARAMS,
        "training/trainer.py:Trainer.train_one_step(opt_state)": OPT_STATE,
        "training/trainer.py:Trainer.evaluate_nsteps(params)": PARAMS,
        "training/trainer.py:Trainer.run_training(params)": PARAMS,
        "training/trainer.py:Trainer.run_training(opt_state)": OPT_STATE,
        "training/trainer.py:Trainer.load_checkpoint(batch_template)": TEMPLATE,
    }),
    **_entries(PALLAS_TILING, {
        "ops/flash_attention.py:flash_attention(block_q)":
            "the Pallas grid's query tile; each CUDA kernel picks its own",
        "ops/flash_attention.py:flash_attention(block_k)":
            "the Pallas grid's key tile; each CUDA kernel picks its own",
        "ops/flash_attention.py:flash_attention(interpret)":
            "the Pallas interpreter; a CPU tensor takes the plain version",
    }),
    **_entries(XLA_ONLY, {
        "utils/system.py:XLA_COMPILE_CACHE_DIR": "XLA's persistent compilation cache",
        "utils/system.py:enable_compilation_cache": "XLA's persistent compilation cache",
    }),
    **_entries(JAX_SHARDING, {
        "data/packed.py:stage_to_device(sharding)":
            "a JAX sharding; the port stages a rank's rows on its DataMesh (mesh)",
        "parallel/mesh.py:make_data_mesh(devices)":
            "a JAX mesh spans the listed devices; a DataMesh is this process's device "
            "(device) in torchrun's process group",
        "parallel/mesh.py:batch_sharding": "a JAX NamedSharding; its counterpart is DataMesh",
        "parallel/mesh.py:replicated": "a JAX NamedSharding; its counterpart is replicate",
        "parallel/serving.py:make_sharded_infer_fn(mesh)":
            "a JAX mesh; the port serves over a list of devices (devices)",
        "training/trainer.py:Trainer.__init__(mesh)":
            "a JAX mesh; the port's trainer takes its device (device) and torchrun's group",
        "training/trainer.py:Trainer.train_one_step(on_device)":
            "marks a batch already sharded on the mesh; shard_batch reads a tensor's device",
    }),
    **_entries(RENAMED, {
        "models/pretrained.py:graft_backbone_into_model_params": "load_backbone_into_model",
        "training/optimizer.py:make_optimizer": "Optimizer",
        "workflows/submit.py:WorkflowStage.tpu_chips": "gpus",
    }),
    **_entries(UNSET_FLAG, {
        "models/clip_resnet_fpn.py:ClipResNet50Fpn.freeze_backbone":
            "always True in the JAX package; the port's trunk is always frozen",
        "models/feature_extractors.py:VitFeatureExtractor.freeze_backbone":
            "always True in the JAX package; the port's ViT is always frozen",
        "models/feature_extractors.py:make_feature_extractor(fpn_trainable)":
            "always True in the JAX package; the port's FPN always trains",
    }),
}


def _names(target):
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for element in target.elts for n in _names(element)]
    if isinstance(target, ast.Starred):
        return _names(target.value)
    return []


def _assigned(node):
    if isinstance(node, ast.Assign):
        return [n for target in node.targets for n in _names(target)]
    if isinstance(node, ast.AnnAssign):
        return _names(node.target)
    return []


def _top_level(body, with_imports):
    """name -> defining node of a module body (into ``if`` / ``try`` blocks)."""
    names = {}
    for node in body:
        if isinstance(node, FUNCTIONS + (ast.ClassDef,)):
            names[node.name] = node
        elif isinstance(node, (ast.If, ast.Try)):
            inner = node.body + node.orelse + getattr(node, "finalbody", [])
            inner += [s for handler in getattr(node, "handlers", []) for s in handler.body]
            names.update(_top_level(inner, with_imports))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            if with_imports:
                names.update({(a.asname or a.name).split(".")[0]: node for a in node.names})
        else:
            names.update(dict.fromkeys(_assigned(node), node))
    return names


def _params(function):
    args = function.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    names += [f"*{args.vararg.arg}"] if args.vararg else []
    names += [f"**{args.kwarg.arg}"] if args.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _members(cls, module_names):
    """name -> node of a class's methods and attributes, its bases' first."""
    members = {}
    for base in cls.bases:
        if isinstance(base, ast.Name) and isinstance(module_names.get(base.id), ast.ClassDef):
            members.update(_members(module_names[base.id], module_names))
    for node in cls.body:
        if isinstance(node, FUNCTIONS):
            members[node.name] = node
        else:
            members.update(dict.fromkeys(_assigned(node), node))
    return members


def _all(tree):
    for node in tree.body:
        if isinstance(node, ast.Assign) and "__all__" in _assigned(node):
            return [element.value for element in node.value.elts]
    return []


def _missing_params(key, jax_function, port_function):
    port = _params(port_function)
    return [f"{key}({p})" for p in _params(jax_function) if p not in port]


def _missing_members(key, jax_class, port_class, jax_names, port_names):
    missing = []
    port_members = _members(port_class, port_names)
    init = port_members.get("__init__")
    init_params = _params(init) if isinstance(init, FUNCTIONS) else []
    for name, node in _members(jax_class, jax_names).items():
        if name == "setup" or (name.startswith("_") and name not in ("__init__", "__call__")):
            continue
        if not isinstance(node, FUNCTIONS):
            if name not in port_members and name not in init_params:
                missing.append(f"{key}.{name}")
            continue
        port_name = name if name in port_members else FLAX_TO_TORCH.get(name, name)
        if port_name not in port_members:
            missing.append(f"{key}.{name}")
        elif isinstance(port_members[port_name], FUNCTIONS):
            missing += _missing_params(f"{key}.{name}", node, port_members[port_name])
    return missing


def missing_from_port(relpath):
    """What the port's counterpart of ``relpath`` lacks, as EXCEPTIONS keys."""
    port_path = os.path.join(PORT_PACKAGE, relpath)
    if not os.path.exists(port_path):
        return [relpath]
    with open(os.path.join(JAX_PACKAGE, relpath)) as f:
        jax_tree = ast.parse(f.read())
    with open(port_path) as f:
        port_tree = ast.parse(f.read())
    jax_names = _top_level(jax_tree.body, with_imports=False)
    port_names = _top_level(port_tree.body, with_imports=True)
    port_all = _all(port_tree)
    missing = [f"{relpath}:__all__[{n}]" for n in _all(jax_tree) if n not in port_all]
    for name, node in jax_names.items():
        key = f"{relpath}:{name}"
        port_node = port_names.get(name)
        if name.startswith("_"):
            continue
        if port_node is None:
            missing.append(key)
        elif isinstance(node, FUNCTIONS) and isinstance(port_node, FUNCTIONS):
            missing += _missing_params(key, node, port_node)
        elif isinstance(node, ast.ClassDef) and isinstance(port_node, ast.ClassDef):
            missing += _missing_members(key, node, port_node, jax_names, port_names)
    return missing


JAX_FILES = sorted(
    os.path.relpath(os.path.join(dirpath, f), JAX_PACKAGE)
    for dirpath, _, files in os.walk(JAX_PACKAGE) for f in files if f.endswith(".py"))


def test_exception_table_holds_only_the_listed_categories():
    assert len(JAX_FILES) > 100
    for key, (category, reason) in EXCEPTIONS.items():
        assert category in CATEGORIES, key
        assert reason, key
        assert os.path.exists(os.path.join(JAX_PACKAGE, key.split(":")[0])), key


@pytest.mark.parametrize("relpath", JAX_FILES)
def test_port_covers_the_jax_module(relpath):
    missing = set(missing_from_port(relpath))
    excepted = {key for key in EXCEPTIONS if key == relpath or key.startswith(relpath + ":")}
    assert sorted(missing - excepted) == [], "missing from the port"
    assert sorted(excepted - missing) == [], "stale entries of EXCEPTIONS"
