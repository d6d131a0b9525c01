"""Sort one array over two gloo ranks on the CPU with the PyTorch port's
distributed sort.

    PYTHONPATH=src python examples/torch_sharded_sort.py

Each rank holds a shard of one seeded array; ``make_sharded_sort``
builds the ShardPlan, and ``run`` returns this rank's slice of the
sorted order: keys, their global indices, and how many of them are
valid.  The ranks' valid slices, in rank order, are the stably sorted
array.  On a card, pass the shard as a CUDA tensor (every rank on its
own card, or several ranks sharing one with a gloo group, as
``chip_smoke.py`` does).
"""

import torch

from repro_torch.core import SortConfig, make_sharded_sort
from repro_torch.launch.mesh import run_ranks

N = 100_000


def keys() -> torch.Tensor:
    gen = torch.Generator().manual_seed(0)
    return torch.randint(-1000, 1000, (N,), generator=gen, dtype=torch.int32)


def rank_main(rank: int, world: int):
    run, plan = make_sharded_sort(None, N, SortConfig(), device="cpu")
    n_local = N // world
    k, idx, count, _ = run(keys()[rank * n_local:(rank + 1) * n_local])
    return k[:count], idx[:count], plan.describe()


def main() -> None:
    parts = run_ranks(rank_main, 2)
    want = torch.sort(keys(), stable=True)
    assert torch.equal(torch.cat([p[0] for p in parts]), want.values)
    assert torch.equal(torch.cat([p[1] for p in parts]).long(), want.indices)
    print(parts[0][2])
    print("sharded sort OK:", [len(p[0]) for p in parts], "keys a rank")


if __name__ == "__main__":
    main()
