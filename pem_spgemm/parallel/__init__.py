from pem_spgemm.parallel.sharded import (ShardedPlan, plan_sharded_spgemm,
                                         sharded_numeric, make_mesh)

__all__ = ["ShardedPlan", "plan_sharded_spgemm", "sharded_numeric",
           "make_mesh"]
