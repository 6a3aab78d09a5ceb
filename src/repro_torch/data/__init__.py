"""The paper's dataset clones (``datasets``) and their logged-replay
tables (``replay``); ``datasets.make_env`` is the front door."""
