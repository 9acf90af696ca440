"""The system under test: the port's models, built as its experiment CLI
builds them, holding weights the benchmark made from the seed.

The configuration names the CLI's flags (``cli``) and, for each network
(``weights``: name -> where it lives among ``build_models``' models), the
reference's layout of it, from which the seeded state dict is made.  The
port's modules take the reference state-dict layout, so the same state dict
loads into both sides.
"""

from __future__ import annotations

from .seeds import derive, seeded_state_dict


def module_at(models: dict, path: str):
    """``engine.stcn`` -> ``models["engine"].stcn``."""
    head, *rest = path.split(".")
    obj = models[head]
    for part in rest:
        obj = getattr(obj, part)
    return obj


def state_dicts(config: dict, reference, seed: int, device, dtypes: dict) -> dict:
    """{network: seeded state dict in ``dtypes[network]``}, made on
    ``device``, one stream of the seed a network."""
    templates = reference.templates(config)
    return {name: seeded_state_dict(templates[name], derive(seed, f"weights.{name}"),
                                    device, dtypes[name])
            for name in config["weights"]}


def build(config: dict, reference, seed: int, device: str,
          precision: str | None = None) -> dict:
    """The CLI's ``build_models`` at the configuration's flags (with
    ``--dtype precision`` where given), each network then loaded with the
    seeded weights in its own dtype."""
    import torch
    from eva_vos_tpu_torch.cli.eval_annotation_method import (build_models,
                                                              build_parser)

    argv = list(config["cli"]) + ["--allow-random", "--device", device]
    if precision:
        argv += ["--dtype", precision]
    models = build_models(build_parser().parse_args(argv))
    mods = {n: module_at(models, p) for n, p in config["weights"].items()}
    dtypes = {n: next(m.parameters()).dtype for n, m in mods.items()}
    for name, sd in state_dicts(config, reference, seed, device, dtypes).items():
        mods[name].load_state_dict(sd)
    torch.cuda.synchronize() if device.startswith("cuda") else None
    return models
