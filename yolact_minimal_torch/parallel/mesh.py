"""Data parallelism: the process group, the mesh of replicas and the
collectives of a multi-process train step.

The port's counterpart of the JAX package's `parallel/mesh.py`. There one
jitted graph runs over a global batch sharded on a 1-D `data` mesh; here
each process runs its own rows and the collectives below make the step the
one-process step on the global batch:

  * `initialize_distributed` joins a `torch.distributed` process group from
    the YOLACT_COORDINATOR / YOLACT_NUM_PROCESSES / YOLACT_PROCESS_ID
    contract (or torchrun's env:// variables with 'auto'); nccl for CUDA,
    gloo for the CPU. Each process then feeds `global_bs / process_count`
    rows (`data/coco.py::TrainLoader`);
  * `global_sum` sums a tensor over the world: BatchNorm's statistics and
    their gradients (models/resnet.py), the losses' normalizers
    (ops/losses.py) and the logged losses (train.py);
  * `global_rows` says which rows of the global batch are this process's:
    random draws take the global shape and keep those rows
    (models/swin.py::drop_path, ops/losses.py), so a world of N draws what
    one process draws;
  * `broadcast_module` gives every process rank 0's weights, `shard_batch`
    moves a process's rows to its device, and `all_reduce_grads` sums the
    gradients over the world after backward() (train_state.py). The global
    loss is the sum of the processes' partial losses, so its gradient is
    that sum, where DistributedDataParallel would take the mean;
  * `make_mesh` lists the devices of a data-parallel Detector
    (pipeline.py), one replica each.

Without a process group (or in a world of one) every helper is the
identity, and a step is the plain step.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

# A process waits at a collective while process 0 validates alone
# (train.py); NCCL's default of 10 minutes is shorter than a validation
# over COCO's val set.
TIMEOUT = datetime.timedelta(hours=2)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: Union[str, torch.device] = 'cuda') -> bool:
    """Join the process group of a multi-process run. Returns True if one
    was joined, False (doing nothing) without configuration.

    Configuration, by precedence: the arguments; YOLACT_COORDINATOR
    ('host:port' of process 0), YOLACT_NUM_PROCESSES (default 1) and
    YOLACT_PROCESS_ID (default 0); coordinator 'auto' reads torchrun's
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK (env://). The backend is
    nccl where `device` is CUDA and gloo on the CPU, unless `backend` says
    otherwise. A CUDA process works on cuda:(process_id % device_count)."""
    coordinator = coordinator or os.environ.get('YOLACT_COORDINATOR')
    if coordinator is None:
        return False
    if coordinator == 'auto':
        init_method = 'env://'
        num_processes = int(os.environ['WORLD_SIZE'])
        process_id = int(os.environ['RANK'])
    else:
        init_method = f'tcp://{coordinator}'
        if num_processes is None:
            num_processes = int(os.environ.get('YOLACT_NUM_PROCESSES', '1'))
        if process_id is None:
            process_id = int(os.environ.get('YOLACT_PROCESS_ID', '0'))
    cuda = torch.device(device).type == 'cuda'
    backend = backend or ('nccl' if cuda else 'gloo')
    if cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)
    return True


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def distributed() -> bool:
    """True in a process group of more than one process."""
    return _joined() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if _joined() else 0


def process_count() -> int:
    return dist.get_world_size() if _joined() else 1


def is_main_process() -> bool:
    """Process 0 logs, validates and writes checkpoints."""
    return process_index() == 0


def local_device(device: Union[str, torch.device] = 'cuda') -> torch.device:
    """This process's device: cuda:(process_index % device_count) for a
    CUDA device without an index in a process group, else `device`."""
    device = torch.device(device)
    if device.type != 'cuda' or device.index is not None or not _joined():
        return device
    return torch.device('cuda', process_index() % torch.cuda.device_count())


def barrier():
    if distributed():
        dist.barrier()


def destroy():
    if _joined():
        dist.destroy_process_group()


def make_mesh(n: Optional[int] = None,
              device: Union[str, torch.device] = 'cuda') -> List[torch.device]:
    """The devices of a data-parallel Detector, one replica each: the first
    n CUDA devices (all without n), or n CPU replicas for device 'cpu'.
    Raises where n exceeds the CUDA devices there are (JAX's make_mesh
    takes fewer)."""
    if torch.device(device).type == 'cpu':
        return [torch.device('cpu')] * (n or 1)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n is None else n
    if n < 1 or n > count:
        raise ValueError(f'a mesh of {n} CUDA devices: this machine has {count} '
                         f'CUDA device{"" if count == 1 else "s"}')
    return [torch.device('cuda', i) for i in range(n)]


def shard_batch(batch: Dict[str, np.ndarray],
                device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """This process's rows (the loader's batch) on its device, copied
    without blocking from pinned memory to a CUDA device."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == 'cuda' and t.device.type == 'cpu':
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def global_rows(rows: int) -> Tuple[int, int]:
    """(rows of the global batch, offset of this process's) for a process
    that holds `rows`; every process holds as many."""
    return rows * process_count(), rows * process_index()


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the world, without gradient; t itself outside one."""
    if not distributed():
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out)
    return out


def _flat_apply(tensors: List[torch.Tensor], collective):
    """Run `collective` on the tensors laid end to end (one buffer per
    dtype, so channels_last tensors need no care), then copy back."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def broadcast_module(module: torch.nn.Module):
    """Every process takes process 0's parameters and buffers."""
    if distributed():
        with torch.no_grad():
            _flat_apply(list(module.state_dict().values()), lambda t: dist.broadcast(t, 0))


def all_reduce_grads(params: Iterable[torch.nn.Parameter]):
    """Each parameter's gradient summed over the world (a missing one taken
    as zeros, so that every process sends the same tensors)."""
    if not distributed():
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _flat_apply([p.grad for p in params], dist.all_reduce)
