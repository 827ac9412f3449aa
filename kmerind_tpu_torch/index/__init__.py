"""Run-layout stores, per-shard steps and the index API."""
