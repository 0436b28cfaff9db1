"""TIMESTAMP WITH TIME ZONE support — not ported yet.

The reference's trino_tpu/ops/tz.py is queued (ROADMAP §1 item 6). The
analyzer imports this module lazily for zone-bearing literals and
functions; any use raises NotImplementedError naming the queue item.
"""


def __getattr__(name):
    raise NotImplementedError(
        f"ops.tz.{name}: TIMESTAMP WITH TIME ZONE is ROADMAP §1 item 6"
    )
