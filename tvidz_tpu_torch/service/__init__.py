"""The port's inspector service: ``app.create_app`` / ``app.InspectorApp``
and the process ``entrypoint``."""
