"""Command-line interface: a Trainer, its strategy and the module from flags or YAML (counterpart of ``ray_lightning_tpu/cli.py``).

The reference's LightningCLI test (``tests/test_lightning_cli.py:11-27``)
builds a strategy by name from command-line arguments, its constructor
arguments resolved against the strategy's own signature and passed
through to its keyword arguments otherwise (``RayStrategy`` hands them
to ``DistributedDataParallel``, e.g. ``bucket_cap_mb``).

The parser is plain argparse with signature introspection, as the JAX
package's: every ``--trainer.X``, ``--model.X``, ``--data.X`` and
``--strategy.X`` flag (or ``--section.X=value``) maps onto that
constructor's parameter, its string coerced by the parameter's default;
``--config file.yaml`` merges a tree with sections ``trainer`` /
``strategy`` / ``model`` / ``data``, the flags winning. YAML is read only
behind ``--config``; nothing else imports it.

``STRATEGY_REGISTRY`` holds the JAX package's names and aliases for the
four ported strategies; its multi-axis mesh strategies' names raise
``NotImplementedError`` (``ROADMAP.md`` A, item 9).

    python -m ray_lightning_tpu_torch.cli --model-class \\
        ray_lightning_tpu_torch.models.GPTModule fit --strategy ddp_sharded \\
        --strategy.num_workers 1 --model.size small --model.optimizer adafactor

``main`` prints the stage's ``callback_metrics`` as one JSON line last.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
from typing import Any, Dict, List, Optional, Type

from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.strategies import (FSDPStrategy,
                                                HorovodRayStrategy,
                                                RayShardedStrategy,
                                                RayStrategy, Strategy)

#: name -> class: each strategy's ``strategy_name`` and the JAX
#: package's aliases
STRATEGY_REGISTRY: Dict[str, Type[Strategy]] = {}

#: the JAX package's names of strategies not ported yet
UNPORTED_STRATEGIES = ("mesh_tpu", "mesh", "sequence_parallel_tpu", "sp",
                       "sequence_parallel")
_MESH_ITEM = "ROADMAP.md A, item 9: multi-axis meshes"


def register_strategy(cls: Type[Strategy], *aliases: str) -> None:
    STRATEGY_REGISTRY[cls.strategy_name] = cls
    for a in aliases:
        STRATEGY_REGISTRY[a] = cls


register_strategy(RayStrategy, "ddp", "dp")
register_strategy(HorovodRayStrategy, "horovod", "allreduce")
register_strategy(RayShardedStrategy, "ddp_sharded", "zero1")
register_strategy(FSDPStrategy, "fsdp_tpu")


_TRUE = ("true", "1", "yes", "y", "on")
_FALSE = ("false", "0", "no", "n", "off")


def _parse_value(raw: str, default: Any) -> Any:
    """A flag's string as the parameter's type (inferred from its
    default)."""
    if raw.lower() in ("null", "none"):
        return None
    if isinstance(default, bool):
        low = raw.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise SystemExit(f"Expected a boolean (true/false), got {raw!r}")
    if isinstance(default, int):
        try:
            return int(raw)
        except ValueError:
            pass
    if isinstance(default, float):
        try:
            return float(raw)
        except ValueError:
            pass
    if isinstance(default, str):
        return raw
    if default is None:
        # an untyped parameter: bool words, int, float, then the string
        if raw.lower() in ("true", "false"):
            return raw.lower() == "true"
        for cast in (int, float):
            try:
                return cast(raw)
            except ValueError:
                continue
    return raw


def _signature_defaults(cls: type) -> Dict[str, Any]:
    out = {}
    for name, p in inspect.signature(cls.__init__).parameters.items():
        if name in ("self", "args", "kwargs"):
            continue
        out[name] = None if p.default is inspect.Parameter.empty \
            else p.default
    return out


def _strategy_class(name: str) -> Type[Strategy]:
    if name in UNPORTED_STRATEGIES:
        raise NotImplementedError(
            f"strategy {name!r} is not ported yet ({_MESH_ITEM})")
    if name not in STRATEGY_REGISTRY:
        raise SystemExit(
            f"Unknown strategy {name!r}; choose from "
            f"{sorted(STRATEGY_REGISTRY)}")
    return STRATEGY_REGISTRY[name]


class TpuLightningCLI:
    """The strategy, trainer, module and data module from command-line
    arguments, and the subcommand run (``run=False`` only builds them)::

        cli = TpuLightningCLI(MyModule, MyDataModule)
        # python train.py fit --trainer.max_epochs 3 \\
        #     --strategy ddp_ray --strategy.num_workers 4 --model.lr 1e-3
    """

    subcommands = ("fit", "validate", "test", "predict")

    def __init__(self,
                 model_class: type,
                 datamodule_class: Optional[type] = None,
                 args: Optional[List[str]] = None,
                 run: bool = True,
                 trainer_defaults: Optional[Dict[str, Any]] = None):
        self.model_class = model_class
        self.datamodule_class = datamodule_class
        ns, overrides = self._parse(args)
        config = self._load_config(ns.config)

        trainer_cfg = dict(trainer_defaults or {})
        trainer_cfg.update(config.get("trainer", {}))
        strategy_cfg = dict(config.get("strategy", {}))
        model_cfg = dict(config.get("model", {}))
        data_cfg = dict(config.get("data", {}))

        strategy_name = ns.strategy or strategy_cfg.pop("name", "ddp_ray")
        strategy_cls = _strategy_class(strategy_name)
        targets = {"trainer": trainer_cfg, "strategy": strategy_cfg,
                   "model": model_cfg, "data": data_cfg}
        defaults = {
            "trainer": _signature_defaults(Trainer),
            "strategy": _signature_defaults(strategy_cls),
            "model": _signature_defaults(model_class),
            "data": _signature_defaults(datamodule_class)
            if datamodule_class else {},
        }
        for section, key, raw in overrides:
            targets[section][key] = _parse_value(
                raw, defaults[section].get(key))

        self.strategy = self._instantiate_strategy(strategy_name,
                                                   strategy_cfg)
        self.trainer = Trainer(strategy=self.strategy, **trainer_cfg)
        self.model = model_class(**model_cfg)
        self.datamodule = (datamodule_class(**data_cfg)
                           if datamodule_class else None)
        self.subcommand = ns.subcommand
        self.result = None
        if run:
            fn = getattr(self.trainer, self.subcommand)
            self.result = fn(self.model, datamodule=self.datamodule)

    def _parse(self, args: Optional[List[str]]):
        args = list(sys.argv[1:] if args is None else args)
        # the subcommand is taken by hand: an optional positional would
        # swallow the value of an unknown --section.param flag
        subcommand = "fit"
        if args and args[0] in self.subcommands:
            subcommand = args.pop(0)
        parser = argparse.ArgumentParser(add_help=True)
        parser.add_argument("--config", default=None,
                            help="YAML config with trainer/strategy/"
                                 "model/data sections")
        parser.add_argument("--strategy", default=None,
                            help=f"one of {sorted(STRATEGY_REGISTRY)}")
        ns, rest = parser.parse_known_args(args)
        ns.subcommand = subcommand

        overrides = []
        i = 0
        while i < len(rest):
            tok = rest[i]
            if not tok.startswith("--") or "." not in tok:
                raise SystemExit(f"Unrecognized argument: {tok}")
            key = tok[2:]
            if "=" in key:
                key, raw = key.split("=", 1)
                i += 1
            else:
                if i + 1 >= len(rest):
                    raise SystemExit(f"Missing value for {tok}")
                raw = rest[i + 1]
                i += 2
            section, _, param = key.partition(".")
            if section not in ("trainer", "strategy", "model", "data"):
                raise SystemExit(
                    f"Unknown section {section!r} in {tok} (use trainer./"
                    "strategy./model./data.)")
            overrides.append((section, param, raw))
        return ns, overrides

    @staticmethod
    def _load_config(path: Optional[str]) -> Dict[str, Any]:
        if not path:
            return {}
        import yaml
        with open(path) as f:
            return yaml.safe_load(f) or {}

    @staticmethod
    def _instantiate_strategy(name: str, cfg: Dict[str, Any]) -> Strategy:
        cls = _strategy_class(name)
        sig_params = set(_signature_defaults(cls))
        known = {k: v for k, v in cfg.items() if k in sig_params}
        # the rest rides the strategy's **kwargs (RayStrategy hands them
        # to DistributedDataParallel, e.g. bucket_cap_mb)
        passthrough = {k: v for k, v in cfg.items() if k not in sig_params}
        return cls(**known, **passthrough)


def _json_value(v: Any) -> Any:
    return v if isinstance(v, (bool, int, float, str)) or v is None \
        else repr(v)


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m ray_lightning_tpu_torch.cli --model-class pkg.Mod
    [--datamodule-class pkg.DM] <subcommand> [flags]``; prints the
    stage's ``callback_metrics`` as one JSON line (floats exact: JSON
    keeps a float's shortest repr)."""
    import importlib
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-class", required=True,
                        help="dotted path to the TpuModule subclass")
    parser.add_argument("--datamodule-class", default=None)
    ns, rest = parser.parse_known_args(argv)

    def _resolve(path):
        mod, _, attr = path.rpartition(".")
        return getattr(importlib.import_module(mod), attr)

    cli = TpuLightningCLI(_resolve(ns.model_class),
                          _resolve(ns.datamodule_class)
                          if ns.datamodule_class else None,
                          args=rest, run=True)
    print(json.dumps({k: _json_value(v) for k, v in
                      cli.trainer.callback_metrics.items()}), flush=True)


if __name__ == "__main__":
    main()
