"""The coded push plane under a SIGKILL, on the port ≡ the JAX
package's ``tests/test_chaos.py:852-858``: a pushing mapper killed
mid-stripe leaves a partial stripe that stays invisible; the stale
requeue covers its job (the port has no speculative clones yet); the
output is byte-identical to the fault-free twin. Its own file: the leg
starts worker processes and waits out a stale timeout."""

from test_torch_chaos import _sigkill_pusher_leg


def test_coded_chaos_sigkill_pusher_midstripe(tmp_path):
    """The SIGKILL-mid-stripe chaos gate: the same storm on
    the coded push plane — a partial stripe (blocks with no member
    manifest) stays invisible, a clone covers the killed producer, and
    the output is byte-identical with zero repetition charges."""
    _sigkill_pusher_leg(tmp_path, "codedkill_wc", coding="4+1")
