"""Port SD UNet under ``attn_impl="flash_nat"`` vs the JAX SDUNet under the
same name, tiny config, fp32 on the CPU, one set of weights (the other
``ATTN_IMPLS`` are held in ``test_torch_sd_unet_attn.py``, with the same
inputs and tolerance; one file each keeps both under a minute).

Every row, self and cross, goes through ``flash_mha(native_long_kv=True)``:
the 1024-, 256- and 64-token self-attention and the 77-token
cross-attention all reach ``_kernel_mh_nat`` (the JAX side runs the Pallas
kernel in interpret mode, the port its plain version on views of the packed
projections).
"""

import test_torch_sd_unet_attn as attn_tests

from superdiff_tpu_torch.models.sd.unet import ATTN_IMPLS

params = attn_tests.params


def test_every_attn_impl_is_held_against_jax():
    assert sorted(attn_tests.IMPLS + ["flash_nat"]) == sorted(ATTN_IMPLS)


def test_unet_matches_jax_under_flash_nat(params):
    attn_tests.test_unet_matches_jax_under_attn_impl(params, "flash_nat")
