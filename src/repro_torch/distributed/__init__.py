"""Serving-side cache operations (the sharded programs wait, ROADMAP
Queue 1)."""
