"""Inference-time model conversion (port of ``nvblox_mindmap_tpu/models/converter.py``).

As in the JAX package, both conversions are settings, not module surgery:

- ``convert_to_flash_attention``: route attention through the flash
  kernel (parameters unchanged; the two impls agree numerically except that
  the kernel outputs zeros, not a uniform average, for a row with no valid
  key, and materializes no weights);
- ``convert_diffusion_scheduler``: DDIM with a reduced step count.
"""
from __future__ import annotations

from typing import Dict

from nvblox_mindmap_torch.ops.attention import set_default_attention_impl


def convert_to_flash_attention() -> Dict:
    """Inference settings that route attention through the flash kernel."""
    return {"attention_impl": "flash"}


def convert_diffusion_scheduler(num_inference_steps: int = 10, eta: float = 0.0) -> Dict:
    """DDIM inference settings (deterministic, eta == 0 only).

    Pass the result to ``sample_trajectory``:
        sample_trajectory(..., **convert_diffusion_scheduler(10))
    """
    if eta != 0.0:
        raise ValueError("only eta=0 (deterministic DDIM) is supported")
    return {
        "scheduler_kind": "ddim",
        "num_inference_steps": num_inference_steps,
        "stochastic": False,
    }


def apply_inference_settings(settings: Dict) -> Dict:
    """Apply the process-wide settings, return the rest for ``sample_trajectory``.

    ``attention_impl`` installs the default attention implementation; it
    takes effect for every later call.
    """
    settings = dict(settings)
    impl = settings.pop("attention_impl", None)
    if impl is not None:
        set_default_attention_impl(impl)
    return settings
