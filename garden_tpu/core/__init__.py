"""Core substrate: math, ECS stores, event schedule, config, logging.

Data-parallel replacement for the reference's layer 0/1 (ecsm + cfnptr/math +
core utilities, SURVEY.md sections 2.1-2.2).
"""
