"""DecByzPG core: registry, attacks, aggregation, agreement, the step."""
