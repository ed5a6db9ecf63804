"""Model definitions of the PyTorch port (functional parameters).

Parameters keep the reference package's tree and layouts, so weights
bridge by a plain copy (:func:`repro_torch.weights.params_from_jax`).
"""

from .common import apply_rope, layer_norm, rms_norm, rope_freqs, softcap
from .attention import (KVCache, attention_decode, attention_forward,
                        init_attention, init_kv_cache, output_proj,
                        project_kv, project_qkv)
from .moe import (ffn_forward, init_ffn, init_mlp, init_moe, mlp_forward,
                  moe_aux_loss, moe_forward)
from .mamba import (MambaCache, init_mamba, init_mamba_cache, mamba_decode,
                    mamba_forward, ssd_chunked)
from .blocks import (block_decode, block_forward, init_block,
                     init_block_cache)
from .model import (abstract_cache, abstract_params, decode_step,
                    embed_inputs, forward, head_logits, init_cache,
                    init_params, loss_fn, prefill)
from .attn_backend import (available_backends, get_backend, register_backend,
                           resolve_backend, resolve_paged_backend)

__all__ = ["apply_rope", "layer_norm", "rms_norm", "rope_freqs", "softcap",
           "KVCache", "attention_decode", "attention_forward",
           "init_attention", "init_kv_cache", "output_proj", "project_kv",
           "project_qkv", "ffn_forward", "init_ffn", "init_mlp", "init_moe",
           "mlp_forward", "moe_aux_loss", "moe_forward", "MambaCache",
           "init_mamba", "init_mamba_cache", "mamba_decode", "mamba_forward",
           "ssd_chunked", "block_decode", "block_forward", "init_block_cache",
           "abstract_cache", "abstract_params", "decode_step",
           "embed_inputs", "forward", "head_logits", "init_block",
           "init_cache", "init_params", "loss_fn", "prefill",
           "available_backends", "get_backend", "register_backend",
           "resolve_backend", "resolve_paged_backend"]
