"""Attribute-style configuration objects loaded from YAML/JSON.

Copy of makani_tpu/utils/yparams.py (the port imports nothing of makani_tpu).
``ParamsBase`` is a dict wrapper allowing attribute access, ``YParams`` loads a
named experiment config from a YAML file with anchor/alias inheritance.
"""

import json

import yaml


class ParamsBase:
    """Dictionary wrapper allowing attribute-style access to config entries."""

    def __init__(self):
        self._original_attrs = None
        self.params = {}
        self._original_attrs = list(self.__dict__)

    def __getitem__(self, key):
        return self.params[key]

    def __setitem__(self, key, val):
        self.params[key] = val
        self.__setattr__(key, val)

    def __contains__(self, key):
        return key in self.params

    def get(self, key, default=None):
        if hasattr(self, key):
            return getattr(self, key)
        return self.params.get(key, default)

    def to_dict(self):
        new_attrs = {key: val for key, val in vars(self).items() if key not in self._original_attrs}
        return {**self.params, **new_attrs}

    @staticmethod
    def from_json(path: str) -> "ParamsBase":
        with open(path) as f:
            c = json.load(f)
        params = ParamsBase()
        params.update_params(c)
        return params

    @staticmethod
    def from_dict(config: dict) -> "ParamsBase":
        params = ParamsBase()
        params.update_params(config)
        return params

    def update_params(self, config):
        for key, val in config.items():
            # sanitize "None" strings (ref: makani/utils/YParams.py:62-63)
            if val == "None":
                val = None
            self.params[key] = val
            self.__setattr__(key, val)


class YParams(ParamsBase):
    """Load the experiment named ``config_name`` from ``yaml_filename``."""

    def __init__(self, yaml_filename, config_name, print_params=False):
        super().__init__()
        self._yaml_filename = yaml_filename
        self._config_name = config_name

        with open(yaml_filename) as f:
            full = yaml.load(f, Loader=yaml.SafeLoader)
        if config_name not in full:
            raise KeyError(f"Config {config_name!r} not found in {yaml_filename}")
        d = full[config_name]

        self.update_params(d)

        if print_params:
            print("------------------ Configuration ------------------")
            for key, val in d.items():
                print(key, val)
            print("---------------------------------------------------")

    def log(self, logger):
        logger.info("------------------ Configuration ------------------")
        logger.info("Configuration file: " + str(self._yaml_filename))
        logger.info("Configuration name: " + str(self._config_name))
        for key, val in self.to_dict().items():
            logger.info(str(key) + " " + str(val))
        logger.info("---------------------------------------------------")
