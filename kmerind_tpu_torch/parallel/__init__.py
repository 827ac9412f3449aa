"""Owner routing of rows between shards."""
