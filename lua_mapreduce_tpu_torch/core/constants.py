"""Engine tuning constants.

Copy of the JAX package's ``core/constants.py`` (reference
mapreduce/utils.lua:27-55), trimmed to the constants the port's barrier
engine consults.
"""

MAX_MAP_RESULT = 5_000            # utils.lua:53 — in-map combiner threshold
MAX_TASKFN_VALUE_SIZE = 16 * 1024 # utils.lua:54 — serialized task-value cap
