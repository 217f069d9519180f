"""Training-curve plotting (reference python/paddle/v2/plot/plot.py; the
port's copy of paddle_tpu/plot.py).

Ploter collects (step, value) series per title and renders them with
matplotlib when available; `DISABLE_PLOT=True` (or matplotlib being
absent) turns `plot()` into a no-op while `append`/`reset` keep working,
matching the reference's headless-CI behavior.
"""
from __future__ import annotations

import os

__all__ = ["PlotData", "Ploter"]


class PlotData:
    def __init__(self):
        self.step = []
        self.value = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(value)

    def reset(self):
        self.step = []
        self.value = []


class Ploter:
    def __init__(self, *args):
        self.__args__ = args
        self.__plot_data__ = {title: PlotData() for title in args}
        self.plt = None
        if not self.__plot_is_disabled__():
            try:
                import matplotlib
                matplotlib.use("Agg")  # headless-safe backend
                import matplotlib.pyplot as plt
                self.plt = plt
            except ImportError:
                pass

    def __plot_is_disabled__(self):
        return os.environ.get("DISABLE_PLOT") == "True"

    def append(self, title, step, value):
        assert title in self.__plot_data__, f"unknown series {title!r}"
        self.__plot_data__[title].append(step, value)

    def plot(self, path=None):
        if self.plt is None:
            return
        titles = []
        for title in self.__args__:
            data = self.__plot_data__[title]
            if len(data.step) > 0:
                titles.append(title)
                self.plt.plot(data.step, data.value)
        self.plt.legend(titles, loc="upper left")
        if path is not None:
            self.plt.savefig(path)
        self.plt.gcf().clear()

    def reset(self):
        for data in self.__plot_data__.values():
            data.reset()
