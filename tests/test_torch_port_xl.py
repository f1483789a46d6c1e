"""PyTorch port at the full FiTv2-XL width (hidden 1152, 16 heads of Dh 72,
SwiGLU 3072, adaLN-LoRA 288) against the JAX package on the CPU.

Slow tier: depth is cut to 4 blocks (the block stack repeats one block, and
a full-depth XL does not belong on a CPU test box); the zero-init leaves are
perturbed so the velocity is not identically 0. fp32 on both sides;
tolerance 1e-4 relative L2 (summation over 1152- and 3072-wide GEMMs in
different orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitv2_tpu.models.fit import FiT as JFiT
from fitv2_tpu.models.grid_utils import make_grid_mask_size as j_grid

from fitv2_tpu_torch.ckpt import state_dict_from_jax
from fitv2_tpu_torch.models import FiT

pytestmark = pytest.mark.slow

XL_WIDTH = dict(context_size=256, patch_size=2, in_channels=4,
                hidden_size=1152, depth=4, num_heads=16, num_classes=1000,
                learn_sigma=False, use_sit=True, use_swiglu=True,
                q_norm='layernorm', k_norm='layernorm', adaln_type='lora',
                adaln_lora_dim=288, max_cached_len=64)


@pytest.mark.parametrize('bucket', [(16, 16), (10, 20)],
                         ids=['full_256', 'padded_160x320'])
def test_xl_width_forward_matches_jax(bucket):
    n_h, n_w = bucket
    jm = JFiT(**XL_WIDTH)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 256, 16)).astype(np.float32)
    t = np.array([0.3, 0.3], np.float32)
    y = np.array([207, 1000])  # a class and the CFG null class
    g, m, s = j_grid(2, n_h, n_w, 256)
    mask = None if n_h * n_w == 256 else m
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(t), jnp.asarray(y), g, mask,
                              s)['params']

    def perturb(path, v):
        p = jax.tree_util.keystr(path)
        if 'fc_out' in p or 'final_layer' in p:
            return v + 0.02 * rng.standard_normal(v.shape).astype(v.dtype)
        return v
    params = jax.tree_util.tree_map_with_path(perturb, params)
    want = np.asarray(jax.jit(jm.apply)({'params': params}, jnp.asarray(x),
                                        jnp.asarray(t), jnp.asarray(y), g,
                                        mask, s))
    pm = FiT(**XL_WIDTH)
    pm.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), depth=4, num_heads=16,
        adaln_type='lora'))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(y), torch.from_numpy(np.array(g)),
                        None if mask is None else torch.from_numpy(
                            np.array(mask)),
                        torch.from_numpy(np.array(s))).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert np.linalg.norm(want) > 0
    assert rel < 1e-4, rel
