"""Seeded weights made on the device in a few large calls.

One normal draw fills a flat buffer for every parameter that a list of
specs names (reference/*.py ``param_specs``: name, shape, std, mean);
each parameter's slice is then scaled and shifted, and the buffer is cast
once to the dtype the weights are served in. The same seed gives the
same weights on the same device, so the reference regenerates them
instead of reading the program's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], float, float]


def make(specs: Sequence[Spec], seed: int, device, dtype=torch.float32
         ) -> Dict[str, torch.Tensor]:
    """name -> tensor of ``dtype`` on ``device``: views of one buffer."""
    numels = [int(torch.Size(shape).numel()) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(numels), generator=gen, device=device,
                       dtype=torch.float32)
    parts: List[torch.Tensor] = list(flat.split(numels))
    torch._foreach_mul_(parts, [float(std) for _, _, std, _ in specs])
    shifted = [(p, float(mean)) for p, (_, _, _, mean) in zip(parts, specs)
               if mean]
    if shifted:
        torch._foreach_add_([p for p, _ in shifted], [m for _, m in shifted])
    if dtype != torch.float32:
        flat = flat.to(dtype)
        parts = list(flat.split(numels))
    return {name: part.view(shape)
            for (name, shape, _, _), part in zip(specs, parts)}


def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor],
         allow_missing: Sequence[str] = ()) -> None:
    """Copies ``weights`` into ``module``'s parameters; every parameter not
    under a prefix of ``allow_missing`` must be given, and nothing else."""
    missing, unexpected = module.load_state_dict(weights, strict=False)
    missing = [n for n in missing
               if not any(n.startswith(p) for p in allow_missing)]
    if missing or unexpected:
        raise KeyError(f'weights do not fit the module: missing '
                       f'{missing[:5]}, unexpected {unexpected[:5]}')
