"""The coded push plane under a SIGKILL, on the port ≡ the JAX
package's ``tests/test_chaos.py:852-858``: a pushing mapper killed
mid-stripe leaves a partial stripe that stays invisible; the stale
requeue covers its job, or (the JAX file's form) a speculative clone
with the stale requeue off; the output is byte-identical to the
fault-free twin. Its own file: the legs start worker processes and wait
out a stale timeout."""

from test_torch_chaos import _sigkill_pusher_leg


def test_coded_chaos_sigkill_pusher_midstripe(tmp_path):
    """The SIGKILL-mid-stripe chaos gate: the same storm on the coded
    push plane — a partial stripe (blocks with no member manifest) stays
    invisible, the stale requeue covers the killed producer (one
    repetition), and the output is byte-identical."""
    _sigkill_pusher_leg(tmp_path, "codedkill_wc", coding="4+1")


def test_coded_chaos_sigkill_pusher_midstripe_clone_covers(tmp_path):
    """The same storm with the stale requeue off and speculation on: a
    clone covers the killed producer at zero repetitions."""
    _sigkill_pusher_leg(tmp_path, "codedkill_clone_wc", coding="4+1",
                        clone=True)
