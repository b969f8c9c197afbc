"""The distribution layer: ``ft`` (step watchdog), ``steps`` (the train,
prefill and decode step builders, on one device or a mesh), ``planner`` and
``shardctx`` (the mesh's shardings, on DTensor), ``compression`` (int8 +
error-feedback all-reduce) and ``pipeline`` (GPipe over a mesh axis)."""
