"""``minedojo.tasks`` of the stand-in: ``ALL_TASKS_SPECS`` (task id -> its
spec), which ``minedojo.make`` reads and, in MineDojo, mutates."""
ALL_TASKS_SPECS = {
    "open-ended": {"__cls__": "open-ended"},
    "harvest_milk": {"__cls__": "harvest", "target_names": "milk_bucket", "target_quantities": 1,
                     "initial_inventory": {"mainhand": {"name": "bucket"}}},
    "harvest_log": {"__cls__": "harvest", "target_names": "log", "target_quantities": 1},
}
