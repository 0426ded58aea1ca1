"""Fixture module: registry, README, and smoke all agree."""


class Obs:
    def __init__(self, m):
        self.steps = m.counter(
            "mpi_tpu_fixture_steps_total", "steps taken")
        self.steps.series(status="ok")

    def tick(self, tracer):
        with tracer.span("fixture_step", status="ok"):
            self.steps.series(status="ok").inc()
