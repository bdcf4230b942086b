"""Loop tick: accepted loops per tick whose Scan Context gate passed
candidates (``loop_count / verify_fired``), the useful outcomes per
verifying tick; nothing where no tick verified."""

UNIT = "loops/tick"


def read(run):
    fired = run.counters.get("verify_fired", 0)
    if not fired:
        return None
    return run.counters["loop_count"] / fired
