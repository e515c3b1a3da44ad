"""Multi-device sharding: `mesh` (devices and the process group) and
`sharded` (`ShardedIndex`, its searches and their merge)."""
