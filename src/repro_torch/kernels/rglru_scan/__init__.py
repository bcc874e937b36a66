"""RG-LRU linear recurrence: the Hopper kernel, its plain version and the wrapper."""
