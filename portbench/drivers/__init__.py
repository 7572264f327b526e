"""One driver per kind of traffic (the mix file's ``driver``). Each has
``setup(run)``, ``window(run) -> end-to-end values``, ``traced(run) ->
units of work``, ``release(run)`` and ``check(run) -> [(name, value,
limit)]``."""
