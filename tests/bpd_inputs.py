"""Write the inputs of ``test_torch_cifar_bpd.py``'s tiny-ScoreUNet dopri5
case (the port's carried weights, the batch and JAX's Rademacher probe)
to an ``.npz``, for ``scripts/torch_bpd_host.py`` on a machine without JAX:

    python3 tests/bpd_inputs.py build/bpd_inputs.npz
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from test_torch_cifar_bpd import _score_unet  # noqa: E402


def main(path):
    _, _, net, x0, _, probe = _score_unet()
    params = {f"param:{k}": v.numpy() for k, v in net.state_dict().items()}
    np.savez(path, x0=x0, probe=probe.numpy(), **params)


if __name__ == "__main__":
    main(sys.argv[1])
