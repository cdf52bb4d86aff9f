"""One process of a gloo world on the CPU for tests/test_torch_parallel.py.

    python tests/_torch_parallel_worker.py SPEC.json

with YOLACT_COORDINATOR, YOLACT_NUM_PROCESSES and YOLACT_PROCESS_ID set.
The process joins the world through `parallel/mesh.py::initialize_distributed`
(the train CLI's path), builds the train state of SPEC's config (weights
from SPEC's `weights` file, else the seeded init; process 0's are
broadcast), takes its rows of the global batch in SPEC's `batch` npz and
runs one `train_step` on them, once in each of SPEC's `dtypes` from a fresh
state. It writes to `out_{process}.npz`, for each dtype, the losses summed
over the world, a per-tensor checksum of its parameters and, in process 0,
every gradient (summed over the world) and every tensor of the state_dict
after the step, under '{dtype}/...'.
"""
import json
import sys

import numpy as np
import torch


def main():
    torch.set_num_threads(1)
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    from yolact_minimal_torch.config import get_config
    from yolact_minimal_torch.parallel import mesh
    from yolact_minimal_torch.train_state import create_train_state, train_step

    assert mesh.initialize_distributed(device='cpu'), 'YOLACT_COORDINATOR is not set'
    try:
        rank, world = mesh.process_index(), mesh.process_count()
        data = dict(np.load(spec['batch']))
        priorities = data.pop('priorities', None)
        global_bs = len(data['image'])
        cfg = get_config(spec['cfg'], mode='train', train_bs=global_bs, **spec['overrides'])
        weights = torch.load(spec['weights']) if spec.get('weights') else None
        rows = global_bs // world
        batch = {k: v[rank * rows:(rank + 1) * rows] for k, v in data.items()}
        if priorities is not None:
            priorities = torch.from_numpy(priorities)
        out = {}
        for dtype in spec['dtypes']:
            state = create_train_state(cfg, 'cpu', seed=0, state_dict=weights)
            step_batch = batch
            if dtype == 'float64':
                state.model.double()
                step_batch = dict(batch, image=batch['image'].astype(np.float64))
            losses = train_step(state, step_batch, priorities=priorities)
            out[f'{dtype}/losses'] = mesh.global_sum(torch.stack(losses)).numpy()
            out[f'{dtype}/checksum'] = np.array([float(t.double().sum()) for t in
                                                 state.model.state_dict().values()])
            if rank == 0:
                for k, p in state.model.named_parameters():
                    out[f'{dtype}/grad/{k}'] = p.grad.numpy()
                for k, v in state.model.state_dict().items():
                    out[f'{dtype}/state/{k}'] = v.numpy()
            print(f'process {rank} of {world}, {dtype}: losses '
                  f'{out[f"{dtype}/losses"].tolist()}', flush=True)
        np.savez(f'{spec["out"]}_{rank}.npz', **out)
    finally:
        mesh.destroy()


if __name__ == '__main__':
    main()
