"""Port SD UNet under the plain ``attn_impl``s (``einsum``: the explicit fp32
softmax; ``dpa``: one ``scaled_dot_product_attention`` call, JAX's
``dot_product_attention``) vs the JAX SDUNet under the same one, tiny
config, fp32 on the CPU: the check, inputs and tolerance of
``test_torch_sd_unet_attn.py``, split from that file so that each stays
under a minute."""

import pytest
import torch
from test_torch_sd_unet_attn import check_unet_under_attn_impl, params  # noqa: F401

torch.set_num_threads(1)

IMPLS = ["einsum", "dpa"]


@pytest.mark.parametrize("attn_impl", IMPLS)
def test_unet_matches_jax_under_attn_impl(params, attn_impl):
    check_unet_under_attn_impl(params, attn_impl)
