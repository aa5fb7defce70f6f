"""Stages 2 and 3 of the pipeline: band storage, reflectors, schedule,
bulge chasing and bisection."""
