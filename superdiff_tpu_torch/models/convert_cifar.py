"""Reference CIFAR ScoreNet checkpoint -> ScoreUNet param tree (port of
``superdiff_tpu/models/convert_cifar.py``, on nested dicts of numpy arrays).

The reference CIFAR stack is Flax (``cifar/models/ddpm.py``); its trained
checkpoints convert to the ScoreUNet layout by pure path rewriting, and
``models/from_jax.py::state_dict_from_flax`` then carries the tree into the
port's :class:`~superdiff_tpu_torch.models.unet.ScoreUNet`. Type renames
(module creation order is identical on both sides, so Flax's per-type
auto-numbering lines up):

    ResnetBlockDDPM_i -> ResnetBlock_i
    GroupNorm_k       -> GroupNorm32_k/GroupNorm_0
    AttnBlock NIN_k   -> Dense_k            (leaves W/b -> kernel/bias)
    Resnet NIN_0      -> Dense_1  (shortcut; Dense_0 is the temb proj)
"""

from __future__ import annotations

from typing import Any, Dict, Mapping


def _leaves(tree: Mapping, path=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, path + (str(key),))
        else:
            yield path + (str(key),), val


def convert_scorenet_params(ref_params: Mapping[str, Any]) -> Dict:
    """Rewrite a reference ``ScoreNet`` param tree into ScoreUNet's layout."""
    out: Dict = {}
    for toks, leaf in _leaves(ref_params):
        new = []
        in_resnet = False
        for tok in toks:
            if tok.startswith("ResnetBlockDDPM_"):
                in_resnet = True
                new.append(tok.replace("ResnetBlockDDPM_", "ResnetBlock_"))
            elif tok.startswith("GroupNorm_"):
                new.extend([tok.replace("GroupNorm_", "GroupNorm32_"), "GroupNorm_0"])
            elif tok.startswith("NIN_"):
                idx = int(tok.split("_")[1])
                new.append(f"Dense_{idx + 1}" if in_resnet else f"Dense_{idx}")
            elif tok == "W":
                new.append("kernel")
            elif tok == "b":
                new.append("bias")
            else:
                new.append(tok)
        node = out
        for tok in new[:-1]:
            node = node.setdefault(tok, {})
        node[new[-1]] = leaf
    return out
