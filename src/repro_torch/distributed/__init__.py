"""The distribution layer, one device so far: ``ft`` (step watchdog) and
``steps`` (the train, prefill and decode step builders). The mesh's
modules (sharding context, planner, pipeline, compression) come with it."""
