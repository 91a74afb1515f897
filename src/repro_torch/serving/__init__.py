"""Serving: the paged int8 KV pool and the continuous-batching engine."""
