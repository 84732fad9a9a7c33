"""Config files (the port's copy of ``ipoke_tpu/config.py``): the YAML
surface with nested sections general/data/architecture/..., and the run
directories ``<base_dir>/<experiment>/{ckpt,config,generated,log}/<model>``.

PyYAML is imported where a file is read or written, so the rest of the port
runs where it is not installed.
"""
from __future__ import annotations

import os
import sys


def _yaml():
    import yaml

    def tuple_constructor(loader, node):
        return tuple(loader.construct_sequence(node))

    yaml.SafeLoader.add_constructor("tag:yaml.org,2002:python/tuple", tuple_constructor)
    return yaml


def load_yaml(path):
    with open(path) as f:
        return _yaml().safe_load(f)


def save_yaml(cfg, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        _yaml().safe_dump(cfg, f, sort_keys=False)


def load_parameters(config_path, model_name, base_dir=None, restart=False, test_mode="none"):
    """On resume or test, the run's saved config wins over the given config,
    except its ``testing:`` section, which is always taken from the given
    one.  base_dir: the argument, else the config's ``general.base_dir``,
    else "logs"."""
    cli_cfg = load_yaml(config_path)
    if base_dir is None:
        base_dir = cli_cfg.get("general", {}).get("base_dir", "logs")
    experiment = cli_cfg["general"]["experiment"]
    dirs = {
        kind: os.path.join(base_dir, experiment, kind, model_name)
        for kind in ("ckpt", "config", "generated", "log")
    }
    saved = os.path.join(dirs["config"], "config.yaml")
    if (not restart and test_mode == "none" and os.path.exists(saved)
            and not cli_cfg.get("general", {}).get("debug")):
        # training a name that already exists asks whether to resume (y ->
        # the saved config wins) or overwrite (n); only an interactive terminal
        # is asked
        if sys.stdin is not None and sys.stdin.isatty():
            print("WARNING: Model has been started somewhen earlier: "
                  "Resume training (y/n)?")
            while True:
                answer = input().strip().lower()
                if answer in ("y", "yes"):
                    restart = True
                    break
                if answer in ("n", "no"):
                    break
                print("Invalid answer! Try again!(y/n)")
    if (restart or test_mode != "none") and os.path.exists(saved):
        cfg = load_yaml(saved)
        cfg["testing"] = cli_cfg.get("testing", cfg.get("testing", {}))
    else:
        cfg = cli_cfg
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        save_yaml(cfg, saved)
    cfg.setdefault("general", {})
    cfg["general"]["model_name"] = model_name
    cfg["general"]["base_dir"] = base_dir
    cfg["general"]["restart"] = restart
    cfg["general"]["test"] = test_mode
    return cfg, dirs
