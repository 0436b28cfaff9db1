"""Runtime services of the port. So far the query memory pool
(memory.py); the distributed runtime of trino_tpu/runtime/ is ROADMAP
§1 item 11."""
