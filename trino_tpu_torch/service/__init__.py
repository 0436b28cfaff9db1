"""Auxiliary services: proxy and verifier (the reference's service/
top-level modules — SURVEY.md §2.11: trino-proxy, trino-verifier)."""
