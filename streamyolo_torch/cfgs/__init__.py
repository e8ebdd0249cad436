"""The port's copies of the five shipped configs (``cfgs/*.py``), loaded
by ``exp.get_exp``."""
