"""Command base: wraps each run with a profile.log wall timer.

Mirrors reference `opensfm/commands/command.py:8-27`.
"""

from __future__ import annotations

import time


class CommandBase:
    name = "command"
    help = ""

    def run(self, data, args):
        """Runs the command and returns what its action returned."""
        start = time.time()
        result = self.run_impl(data, args)
        end = time.time()
        data.append_to_profile_log(f"{type(self).name}: {end - start}\n")
        return result

    def add_arguments(self, parser) -> None:
        pass

    def run_impl(self, data, args):
        raise NotImplementedError
