"""DecByzPG and ByzPG core: registry, attacks, aggregation, agreement,
the steps, PAGE, and the experiment engine."""
