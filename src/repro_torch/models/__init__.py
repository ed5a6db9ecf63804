"""Model definitions of the PyTorch port (functional parameters).

Parameters keep the reference package's tree and layouts, so weights
bridge by a plain copy (:func:`repro_torch.weights.params_from_jax`).
"""

from .common import apply_rope, rms_norm, rope_freqs, softcap
from .attention import init_attention, output_proj, project_kv, project_qkv
from .moe import ffn_forward, init_mlp, mlp_forward
from .model import embed_inputs, head_logits, init_block, init_params
from .attn_backend import get_backend, resolve_paged_backend

__all__ = ["apply_rope", "rms_norm", "rope_freqs", "softcap",
           "init_attention", "output_proj", "project_kv", "project_qkv",
           "ffn_forward", "init_mlp", "mlp_forward", "embed_inputs",
           "head_logits", "init_block", "init_params", "get_backend",
           "resolve_paged_backend"]
