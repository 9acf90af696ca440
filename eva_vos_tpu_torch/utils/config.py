"""Unified config layer: YAML files over argparse defaults (a copy of
``eva_vos_tpu/utils/config.py``).

Every CLI uses argparse, and ``apply_yaml_config`` lets any of them take a
``--config file.yaml`` whose (possibly nested) keys override the defaults,
with CLI flags winning over the file.  PyYAML is imported only when a
``--config`` is given.
"""

from __future__ import annotations

import argparse
import sys


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, f"{key}_"))
        else:
            out[key] = v
    return out


def apply_yaml_config(parser: argparse.ArgumentParser, argv=None):
    """Parse with an optional ``--config`` YAML providing defaults.

    Precedence: CLI flag > YAML value > argparse default.
    Nested YAML keys flatten with underscores (``ppo: {clip_param: 0.2}``
    -> ``clip_param`` if the parser has it, else ``ppo_clip_param``).
    """
    parser.add_argument("--config", default=None,
                        help="YAML file with default overrides")
    argv = sys.argv[1:] if argv is None else argv
    pre, _ = parser.parse_known_args(argv)
    if pre.config:
        import yaml

        with open(pre.config) as fh:
            cfg = _flatten(yaml.safe_load(fh) or {})
        known = {a.dest for a in parser._actions}
        defaults = {}
        for k, v in cfg.items():
            if k in known:
                defaults[k] = v
            else:
                # nested key like ppo_clip_param -> clip_param
                tail = k.split("_", 1)[-1]
                if tail in known:
                    defaults[tail] = v
        parser.set_defaults(**defaults)
    return parser.parse_args(argv)
