"""Vision-backbone checkpoints: torch hub state dicts -> the flax-layout tree.

Port of the numpy parts of ``nvblox_mindmap_tpu/models/weight_conversion.py``.
The converted checkpoint format is the JAX package's: a ``.npz`` of the
flax parameter tree with '/'-joined keys, so one converted file serves both
packages. ``models/weights.py`` maps the tree onto the port's modules and
``models/pretrained.py`` loads it into a model.

- ``convert_torch_vit_weights``: timm/DINOv2-style ViT (patch_embed.proj,
  pos_embed, blocks.N.{norm1, attn (fused qkv), norm2, mlp.fc1/fc2}, final
  norm) onto ``VitFeatureExtractor``'s tree. Torch Linear (out, in) -> flax
  kernel (in, out); Conv (out, in, kh, kw) -> (kh, kw, in, out); fused qkv
  -> the (E, heads, head_dim) projections of flax attention.
- ``convert_radio_vit_weights``: the RADIO hub model (``patch_generator``
  stem, ``input_conditioner`` normalization) onto the same tree.
- ``interpolate_pos_embed``: resample pos_embed to another patch grid with
  the antialiased bilinear resize of ``feature_extractors``.
- ``save_variables_npz`` / ``load_variables_npz`` (plain ``np.load``; the
  JAX package's mmap reader is left out until a committed checkpoint shows
  a load time worth it) / ``graft_subtree``.

- ``convert_clip_resnet_weights``: CLIP's ModifiedResNet visual state dict
  (with or without the ``visual.`` prefix; the attention-pool head is
  skipped) onto ``ModifiedResNetFeatures``' tree, the BatchNorms' running
  statistics included.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from nvblox_mindmap_torch.models.feature_extractors import resize_bilinear


def _linear(w: np.ndarray, b: np.ndarray) -> Dict[str, np.ndarray]:
    return {"kernel": np.asarray(w).T, "bias": np.asarray(b)}


def _layernorm(w: np.ndarray, b: np.ndarray) -> Dict[str, np.ndarray]:
    return {"scale": np.asarray(w), "bias": np.asarray(b)}


def convert_torch_vit_weights(
    state_dict: Dict[str, np.ndarray],
    depth: int,
    num_heads: int,
    prefix: str = "",
    num_prefix_tokens: int = 1,
    keep_prefix_tokens: bool = True,
) -> Dict:
    """Map a timm/DINOv2-style ViT state dict onto VitFeatureExtractor params.

    Args:
        state_dict: name -> numpy array (call .numpy() on torch tensors).
        depth: number of transformer blocks.
        num_heads: attention heads.
        prefix: optional key prefix in the state dict (e.g. "model.").
        num_prefix_tokens: CLS (+ register) entries at the head of pos_embed.
        keep_prefix_tokens: emit a 'prefix_tokens' param (cls/register token
            values with their pos-embed slice folded in) so the module runs
            them through attention like the original.

    Returns:
        the flax-layout params dict of VitFeatureExtractor.
    """
    sd = {k[len(prefix):]: np.asarray(v) for k, v in state_dict.items()
          if k.startswith(prefix)}

    params: Dict = {}
    conv_w = sd["patch_embed.proj.weight"]  # (E, 3, p, p)
    params["patch_embed"] = {
        "kernel": conv_w.transpose(2, 3, 1, 0),
        "bias": sd["patch_embed.proj.bias"],
    }
    pos = sd["pos_embed"]  # (1, prefix+N, E)
    params["pos_embed"] = pos[:, num_prefix_tokens:, :]

    width = conv_w.shape[0]
    if keep_prefix_tokens:
        tokens = [sd[key].reshape(1, -1, width)
                  for key in ("cls_token", "register_tokens", "reg_token") if key in sd]
        if tokens:
            prefix_tokens = np.concatenate(tokens, axis=1).copy()
            folded = min(num_prefix_tokens, prefix_tokens.shape[1])
            if folded > 0:
                prefix_tokens[:, :folded] += pos[:, :folded]
            params["prefix_tokens"] = prefix_tokens

    head_dim = width // num_heads
    for i in range(depth):
        b = f"blocks.{i}."
        params[f"ln1_{i}"] = _layernorm(sd[b + "norm1.weight"], sd[b + "norm1.bias"])
        params[f"ln2_{i}"] = _layernorm(sd[b + "norm2.weight"], sd[b + "norm2.bias"])
        # DINOv2 LayerScale gammas: the module must be built with
        # use_layer_scale=True to take them.
        if b + "ls1.gamma" in sd:
            params[f"ls1_{i}"] = sd[b + "ls1.gamma"]
            params[f"ls2_{i}"] = sd[b + "ls2.gamma"]

        q_w, k_w, v_w = np.split(sd[b + "attn.qkv.weight"], 3, axis=0)  # (3E, E)
        q_b, k_b, v_b = np.split(sd[b + "attn.qkv.bias"], 3, axis=0)

        def proj(w, bias):
            # (E_out, E_in) -> (E_in, heads, head_dim)
            return {
                "kernel": w.T.reshape(width, num_heads, head_dim),
                "bias": bias.reshape(num_heads, head_dim),
            }

        out_w = sd[b + "attn.proj.weight"]  # (E, E)
        params[f"attn_{i}"] = {
            "query": proj(q_w, q_b),
            "key": proj(k_w, k_b),
            "value": proj(v_w, v_b),
            "out": {
                "kernel": out_w.T.reshape(num_heads, head_dim, width),
                "bias": sd[b + "attn.proj.bias"],
            },
        }
        params[f"mlp1_{i}"] = _linear(sd[b + "mlp.fc1.weight"], sd[b + "mlp.fc1.bias"])
        params[f"mlp2_{i}"] = _linear(sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"])

    params["ln_final"] = _layernorm(sd["norm.weight"], sd["norm.bias"])
    return params


def interpolate_pos_embed(params: Dict, target_grid: int) -> Dict:
    """Bilinearly resample the patch pos_embed to a new (square) grid size.

    Pretrained ViTs store pos_embed for their training grid (e.g. 16x16 for
    224/14); the extractor may run at another patch grid (e.g. 32x32).
    """
    pos = np.asarray(params["pos_embed"], dtype=np.float32)  # (1, N, E)
    n, e = pos.shape[1], pos.shape[2]
    g = int(round(np.sqrt(n)))
    if g * g != n:
        raise ValueError(f"pos_embed length {n} is not square")
    if g == target_grid:
        return params
    grid = torch.from_numpy(pos.reshape(1, g, g, e))
    resized = resize_bilinear(grid, (target_grid, target_grid)).numpy()
    out = dict(params)
    out["pos_embed"] = resized.reshape(1, target_grid * target_grid, e)
    return out


def convert_radio_vit_weights(
    state_dict: Dict[str, np.ndarray],
    depth: int = 12,
    num_heads: int = 12,
) -> Dict:
    """Map a RADIO torch-hub checkpoint onto VitFeatureExtractor params.

    The RADIO hub model wraps a ViT whose stem is a ``patch_generator``
    (linear patch embedder + cls/register tokens + a patch-only position
    embedding) and whose inputs pass through an ``input_conditioner``
    holding normalization tensors. This converter:

    - strips the ``radio_model.``/``base_model.``/``model.`` wrappers,
    - accepts either a timm stem (``patch_embed.proj.*`` conv weights) or the
      RADIO ``patch_generator`` stem (Conv2d or flattened-Linear embedder),
    - keeps the cls/register tokens as prefix tokens (they attend),
    - returns ``input_conditioner.norm_mean/norm_std`` when present under
      ``norm_mean``/``norm_std``.

    Returns {"params": ..., "norm_mean": (3,)?, "norm_std": (3,)?}.
    """
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    for wrapper in ("radio_model.", "base_model.", "model."):
        if any(k.startswith(wrapper + "blocks.") for k in sd):
            sd = {
                k[len(wrapper):] if k.startswith(wrapper) else k: v
                for k, v in sd.items()
            }

    out: Dict = {}
    mean = sd.get("input_conditioner.norm_mean")
    std = sd.get("input_conditioner.norm_std")
    if mean is not None:
        out["norm_mean"] = np.asarray(mean).reshape(-1)
    if std is not None:
        out["norm_std"] = np.asarray(std).reshape(-1)

    if "patch_generator.embedder.weight" in sd:
        emb_w = sd["patch_generator.embedder.weight"]
        emb_b = sd.get(
            "patch_generator.embedder.bias",
            np.zeros(emb_w.shape[0], emb_w.dtype),
        )
        if emb_w.ndim == 4:  # Conv2d (E, 3, p, p)
            kernel = emb_w.transpose(2, 3, 1, 0)
        else:  # Linear over patches flattened channels-first: (E, 3*p*p)
            e, flat = emb_w.shape
            p = int(round(np.sqrt(flat / 3)))
            if 3 * p * p != flat:
                raise ValueError(f"non-square patch embedder: {emb_w.shape}")
            kernel = emb_w.reshape(e, 3, p, p).transpose(2, 3, 1, 0)
        vit_sd = dict(sd)
        vit_sd["patch_embed.proj.weight"] = np.zeros(
            (kernel.shape[3], 3, kernel.shape[0], kernel.shape[1]), kernel.dtype
        )
        vit_sd["patch_embed.proj.bias"] = emb_b
        vit_sd["pos_embed"] = sd["patch_generator.pos_embed"]  # (1, N, E)
        params = convert_torch_vit_weights(
            vit_sd, depth=depth, num_heads=num_heads, num_prefix_tokens=0,
            keep_prefix_tokens=False,
        )
        params["patch_embed"] = {"kernel": kernel, "bias": emb_b}
        # RADIO's patch_generator concatenates cls/register tokens after the
        # (patch-only) pos embed; they attend, so keep them as prefix tokens.
        width = kernel.shape[-1]
        tokens = [sd[key].reshape(1, -1, width) for key in (
            "patch_generator.cls_token.token",
            "patch_generator.cls_token",
            "patch_generator.register_tokens",
            "patch_generator.registers",
        ) if key in sd]
        if tokens:
            params["prefix_tokens"] = np.concatenate(tokens, axis=1)
    else:
        n_prefix = 0
        if "cls_token" in sd:
            n_prefix += sd["cls_token"].shape[1] if sd["cls_token"].ndim == 3 else 1
        if "register_tokens" in sd:
            n_prefix += sd["register_tokens"].shape[1]
        params = convert_torch_vit_weights(
            sd, depth=depth, num_heads=num_heads, num_prefix_tokens=n_prefix
        )
    out["params"] = params
    return out


def _conv(w: np.ndarray) -> Dict[str, np.ndarray]:
    return {"kernel": np.asarray(w).transpose(2, 3, 1, 0)}


def _batchnorm(prefix: str, sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """torch BatchNorm2d -> FrozenBatchNorm params (running stats included)."""
    return {
        "scale": np.asarray(sd[prefix + ".weight"]),
        "bias": np.asarray(sd[prefix + ".bias"]),
        "mean": np.asarray(sd[prefix + ".running_mean"]),
        "var": np.asarray(sd[prefix + ".running_var"]),
    }


def convert_clip_resnet_weights(state_dict: Dict[str, np.ndarray], layers=(3, 4, 6, 3)) -> Dict:
    """Map CLIP's ModifiedResNet visual state dict onto ModifiedResNetFeatures.

    Keys may carry the ``visual.`` prefix of the full CLIP checkpoint; the
    attention-pool head is not read (the extractor taps the intermediate
    feature maps only). Returns ``{"params": trunk}``, the tree of the
    ``backbone`` submodule of ClipResNet50Fpn.
    """
    sd = {(k[len("visual."):] if k.startswith("visual.") else k): v
          for k, v in state_dict.items()}
    params: Dict = {}
    for i in (1, 2, 3):
        params[f"conv{i}"] = _conv(sd[f"conv{i}.weight"])
        params[f"bn{i}"] = _batchnorm(f"bn{i}", sd)
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            t = f"layer{stage + 1}.{b}"
            block: Dict = {}
            for j in (1, 2, 3):
                block[f"conv{j}"] = _conv(sd[f"{t}.conv{j}.weight"])
                block[f"bn{j}"] = _batchnorm(f"{t}.bn{j}", sd)
            if f"{t}.downsample.0.weight" in sd:
                block["downsample_conv"] = _conv(sd[f"{t}.downsample.0.weight"])
                block["downsample_bn"] = _batchnorm(f"{t}.downsample.1", sd)
            params[f"layer{stage + 1}_{b}"] = block
    return {"params": params}


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        elif value is not None:
            yield path, value


def save_variables_npz(path: str, variables: Mapping[str, Any]) -> None:
    """Flatten a nested dict of arrays to an .npz with '/'-joined keys."""
    np.savez(path, **{key: np.asarray(value) for key, value in _flatten(variables)})


def load_variables_npz(path: str) -> Dict:
    """Inverse of save_variables_npz: .npz -> nested dict of arrays."""
    with np.load(path) as loaded:
        arrays = {key: loaded[key] for key in loaded.files}
    nested: Dict = {}
    for key, value in arrays.items():
        node = nested
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return nested


def graft_subtree(variables: Dict, path: str, subtree: Dict) -> Dict:
    """A copy of ``variables`` with the dict at '/'-path replaced.

    Every node along the path must already exist.
    """
    parts = path.split("/")
    out = dict(variables)
    node = out
    for part in parts[:-1]:
        if part not in node:
            raise KeyError(
                f"graft path component {part!r} not found "
                f"(available: {sorted(node)})"
            )
        node[part] = dict(node[part])
        node = node[part]
    if parts[-1] not in node:
        raise KeyError(
            f"graft target {parts[-1]!r} not found (available: {sorted(node)})"
        )
    node[parts[-1]] = subtree
    return out
