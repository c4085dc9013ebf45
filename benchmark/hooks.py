"""The benchmark's hold on the program: the port's configuration objects
built from a configuration file, and the shapes of the hash-grid kernels'
launches recorded in a traced window (their rooflines' operations and
bytes come from them)."""

from __future__ import annotations

import dataclasses

from benchmark.reference import ngp as ref


def program_configs(config: dict, num_rays: int):
    """(NGPConfig, RenderOptions, TrainConfig) of the port from the
    configuration."""
    from seal3d_tpu_torch.models.ngp import NGPConfig
    from seal3d_tpu_torch.render.renderer import RenderOptions
    from seal3d_tpu_torch.train.trainer import TrainConfig

    def pick(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: (tuple(v) if isinstance(v, list) else v)
                for k, v in d.items() if k in names}

    train = dict(config["train"], num_rays=num_rays, workspace=None)
    return (NGPConfig(**pick(NGPConfig, config["model"])),
            RenderOptions(**pick(RenderOptions, config["render"])),
            TrainConfig(**pick(TrainConfig, train)))


def flat_clone(tree) -> dict:
    return {k: v.detach().clone() for k, v in ref.flatten(tree).items()}


class EncodeCalls:
    """Records the shapes (rows, levels, F) of the hash-grid encode's
    launches while on: `fwd` of K3's forward, `bwd` of the backward, which
    on the 'bucket' backend is K2."""

    def __init__(self):
        import seal3d_tpu_torch.ops.hash_encode as he

        self.he, self.fwd, self.bwd = he, [], []
        self.orig = he._launch_fwd, he._launch_bwd

    def __enter__(self):
        he, (fwd, bwd) = self.he, self.orig

        def f(table, x, cfg):
            self.fwd.append((x.shape[0], cfg.num_levels, table.shape[-1]))
            return fwd(table, x, cfg)

        def b(g, x, cfg, n_rows):
            n = cfg.num_levels
            fd = g.shape[-1] // n if g.dim() == 2 else g.shape[-1]
            self.bwd.append((x.shape[0], n, fd))
            return bwd(g, x, cfg, n_rows)

        he._launch_fwd, he._launch_bwd = f, b
        return self

    def __exit__(self, *exc):
        self.he._launch_fwd, self.he._launch_bwd = self.orig
