"""State builders, one module per kind of configuration, named by the
configuration file's ``builder`` key."""
