"""Logical-axis sharding of the port (``repro/sharding``)."""
from .rules import (ACT_RULES, PARAM_RULES, PIPE_RULES, SP_ACT_RULES,
                    NamedSharding, axis_rules, constrain, current_mesh,
                    logical_sharding, merge_rules, resolve_spec)
