"""Plain references of the benchmark's queries: torch and numpy over the
generated host arrays, one module a query (`<family>/<q>.py`, each with
`run(ctx, params) -> Answer`). Nothing here imports the port."""
