"""misaki_tpu test suite (a package, so that test modules can share
helpers through `tests.<module>` imports whatever else is installed)."""
