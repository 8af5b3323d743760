"""Priority classes of multi-tenant scheduling (reference: paddle_tpu
serving/tenancy.py). Only the classes and their ranks, which the decode
scheduler and the prefix cache order by; quotas, token buckets and the
tenant registry belong to the fleet slice."""

__all__ = ['PRIORITIES', 'PRIORITY_RANK', 'priority_rank']

# Highest class first; the rank (index) is the scheduling key: a lower rank
# is preempted later, evicted later and admitted earlier.
PRIORITIES = ('interactive', 'standard', 'batch')
PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}


def priority_rank(priority):
    """Scheduling rank of a priority-class name; None and unknown names
    land on 'standard', so untenanted traffic schedules as before."""
    return PRIORITY_RANK.get(priority, PRIORITY_RANK['standard'])
