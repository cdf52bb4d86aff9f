"""The program under test, seen from the benchmark: its configuration for a
cell, held to the cell's configuration file. Imported only by the entries,
so that the reference and the readers load nothing of the program."""
from __future__ import annotations


def config(cell, mode: str, **overrides):
    """The program's Config of the cell's registry name, at the cell's image
    size and compute dtype, after checking that it states what the
    configuration file states."""
    from yolact_minimal_torch.config import get_config
    conf = cell.config
    kw = dict(img_size=cell.size('img_size'),
              compute_dtype=cell.overrides.get('compute_dtype', conf['compute_dtype']))
    if mode == 'train':
        kw['train_bs'] = cell.size('batch')
    kw.update(overrides)
    cfg = get_config(conf['program_config'], mode=mode, **kw)
    stated = {'num_classes': conf['model']['num_classes'],
              'aspect_ratios': tuple(conf['model']['aspect_ratios']),
              'base_scales': tuple(conf['model']['base_scales'])}
    stated.update({k: v for k, v in conf['postprocess'].items()})
    stated.update({k: (tuple(v) if isinstance(v, list) else v)
                   for k, v in conf['train'].items() if k != 'lr_steps'})
    stated['base_lr_steps'] = tuple(conf['train']['lr_steps'])
    differ = {k: (getattr(cfg, k), v) for k, v in stated.items()
              if k not in overrides and getattr(cfg, k) != v}
    if differ:
        raise ValueError(f'the program\'s {conf["program_config"]} differs from '
                         f'{conf["name"]}: (program, file) {differ}')
    return cfg
