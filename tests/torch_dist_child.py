"""One rank of ``tests/torch_dist.py``'s world:
``python torch_dist_child.py <port> <rank> <world> <workdir>``."""

import os
import sys

import torch


def main():
    port, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    import torch.distributed as dist

    import torch_parallel_cases as cases
    from superdiff_tpu_torch.parallel.distributed import initialize

    if not os.environ.get("TORCH_DIST_NO_INIT"):
        initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    else:  # the case joins the group itself (the CLI's flags)
        os.environ.update(TORCH_DIST_ADDRESS=f"127.0.0.1:{port}", TORCH_DIST_RANK=str(rank),
                          TORCH_DIST_WORLD=str(world))
    todo = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out = {name: getattr(cases, name.split(":")[0])(inputs) for name, inputs in todo.items()}
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
