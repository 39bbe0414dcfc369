# The paper's primary contribution: Eva's cost-efficient cloud-based cluster
# scheduling — reservation-price provisioning (Algorithm 1), TNRP interference
# awareness, multi-task attribution, and the Full/Partial ensemble criterion.
from .catalog import (AWS_CATALOG, Catalog, CommitmentModel, CreditModel,
                      InstanceType, MarketPriceModel,
                      MeanRevertingPriceModel, PriceModel, Provider, Region,
                      RegionPriceModel, TracePriceModel, TransferMatrix,
                      aws_catalog, burstable_demo_catalog,
                      dispersed_demo_regions, multi_provider_catalog,
                      multi_region_catalog, table3_catalog)
from .cluster_types import (Assignment, ClusterConfig, Job, Task, TaskSet,
                            make_job, make_task)
from .ensemble import EventRateEstimator, choose, mean_time_to_full_reconfig
from .full_reconfig import evaluate_assignments, full_reconfiguration
from .partial_reconfig import (incremental_reconfiguration,
                               partial_reconfiguration)
from .plan import (LiveInstance, Plan, diff_configs, migration_cost,
                   task_move_cost)
from .reservation_price import (cheapest_type, feasibility_matrix, job_rp_sums,
                                regional_reservation_prices,
                                reservation_prices, tnrp)
from .scheduler import EvaScheduler, NoPackingScheduler, SchedulerBase, SchedulerView
from .serving import (RequestProfile, ServiceSpec, UtilityCurve,
                      p99_latency_ms)
from .throughput_table import ThroughputTable
from .workloads import (M_TRUE, NUM_BATCH_WORKLOADS, NUM_WORKLOADS, WORKLOADS,
                        checkpoint_size_gb, true_throughput)

__all__ = [
    "AWS_CATALOG", "Catalog", "CommitmentModel", "CreditModel",
    "InstanceType", "MarketPriceModel", "MeanRevertingPriceModel",
    "PriceModel", "Provider", "Region", "RegionPriceModel",
    "TracePriceModel",
    "TransferMatrix", "aws_catalog", "burstable_demo_catalog",
    "dispersed_demo_regions", "multi_provider_catalog",
    "multi_region_catalog", "table3_catalog",
    "Assignment", "ClusterConfig", "Job", "Task", "TaskSet", "make_job",
    "make_task", "EventRateEstimator", "choose", "mean_time_to_full_reconfig",
    "evaluate_assignments", "full_reconfiguration",
    "incremental_reconfiguration", "partial_reconfiguration",
    "LiveInstance", "Plan", "diff_configs", "migration_cost",
    "task_move_cost", "cheapest_type",
    "feasibility_matrix", "job_rp_sums", "regional_reservation_prices",
    "reservation_prices", "tnrp",
    "EvaScheduler", "NoPackingScheduler", "SchedulerBase", "SchedulerView",
    "RequestProfile", "ServiceSpec", "UtilityCurve", "p99_latency_ms",
    "ThroughputTable", "M_TRUE", "NUM_BATCH_WORKLOADS", "NUM_WORKLOADS",
    "WORKLOADS", "checkpoint_size_gb", "true_throughput",
]
