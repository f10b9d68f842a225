# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: master.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cmaster.proto\x12\x11weedtpu_master_pb\"\xc7\x04\n\tHeartbeat\x12\n\n\x02ip\x18\x01 \x01(\t\x12\x0c\n\x04port\x18\x02 \x01(\r\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\x18\n\x10max_volume_count\x18\x04 \x01(\x04\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\x12\x0c\n\x04rack\x18\x06 \x01(\t\x12<\n\x07volumes\x18\x07 \x03(\x0b\x32+.weedtpu_master_pb.VolumeInformationMessage\x12\x45\n\tec_shards\x18\x08 \x03(\x0b\x32\x32.weedtpu_master_pb.VolumeEcShardInformationMessage\x12\x16\n\x0ehas_no_volumes\x18\t \x01(\x08\x12\x10\n\x08is_delta\x18\n \x01(\x08\x12@\n\x0bnew_volumes\x18\x0b \x03(\x0b\x32+.weedtpu_master_pb.VolumeInformationMessage\x12\x44\n\x0f\x64\x65leted_volumes\x18\x0c \x03(\x0b\x32+.weedtpu_master_pb.VolumeInformationMessage\x12I\n\rnew_ec_shards\x18\r \x03(\x0b\x32\x32.weedtpu_master_pb.VolumeEcShardInformationMessage\x12M\n\x11\x64\x65leted_ec_shards\x18\x0e \x03(\x0b\x32\x32.weedtpu_master_pb.VolumeEcShardInformationMessage\"p\n\x11HeartbeatResponse\x12\x19\n\x11volume_size_limit\x18\x01 \x01(\x04\x12\x0e\n\x06leader\x18\x02 \x01(\t\x12\x17\n\x0fmetrics_address\x18\x03 \x01(\t\x12\x17\n\x0fjwt_signing_key\x18\x04 \x01(\t\"\xda\x01\n\x18VolumeInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x0c\n\x04size\x18\x02 \x01(\x04\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x12\n\nfile_count\x18\x04 \x01(\x04\x12\x14\n\x0c\x64\x65lete_count\x18\x05 \x01(\x04\x12\x1a\n\x12\x64\x65leted_byte_count\x18\x06 \x01(\x04\x12\x11\n\tread_only\x18\x07 \x01(\x08\x12\x19\n\x11replica_placement\x18\x08 \x01(\r\x12\x0f\n\x07version\x18\t \x01(\r\x12\x0b\n\x03ttl\x18\n \x01(\r\"X\n\x1fVolumeEcShardInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x15\n\rec_index_bits\x18\x03 \x01(\r\"i\n\rAssignRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\x04\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\"+\n\x08Location\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\"\xa7\x01\n\x0e\x41ssignResponse\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\r\n\x05\x63ount\x18\x02 \x01(\x04\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12-\n\x08location\x18\x04 \x01(\x0b\x32\x1b.weedtpu_master_pb.Location\x12-\n\x08replicas\x18\x05 \x03(\x0b\x32\x1b.weedtpu_master_pb.Location\x12\x0c\n\x04\x61uth\x18\x06 \x01(\t\"E\n\x13LookupVolumeRequest\x12\x1a\n\x12volume_or_file_ids\x18\x01 \x03(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\"\xdb\x01\n\x14LookupVolumeResponse\x12U\n\x13volume_id_locations\x18\x01 \x03(\x0b\x32\x38.weedtpu_master_pb.LookupVolumeResponse.VolumeIdLocation\x1al\n\x10VolumeIdLocation\x12\x19\n\x11volume_or_file_id\x18\x01 \x01(\t\x12.\n\tlocations\x18\x02 \x03(\x0b\x32\x1b.weedtpu_master_pb.Location\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"*\n\x15LookupEcVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\xdb\x01\n\x16LookupEcVolumeResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12W\n\x12shard_id_locations\x18\x02 \x03(\x0b\x32;.weedtpu_master_pb.LookupEcVolumeResponse.EcShardIdLocation\x1aU\n\x11\x45\x63ShardIdLocation\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12.\n\tlocations\x18\x02 \x03(\x0b\x32\x1b.weedtpu_master_pb.Location\"T\n\x14KeepConnectedRequest\x12\x13\n\x0b\x63lient_type\x18\x01 \x01(\t\x12\x16\n\x0e\x63lient_address\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\t\"\x97\x01\n\x0eVolumeLocation\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x10\n\x08new_vids\x18\x03 \x03(\r\x12\x14\n\x0c\x64\x65leted_vids\x18\x04 \x03(\r\x12\x0e\n\x06leader\x18\x05 \x01(\t\x12\x13\n\x0bnew_ec_vids\x18\x06 \x03(\r\x12\x17\n\x0f\x64\x65leted_ec_vids\x18\x07 \x03(\r\"G\n\x11\x43lusterNodeUpdate\x12\x11\n\tnode_type\x18\x01 \x01(\t\x12\x0f\n\x07\x61\x64\x64ress\x18\x02 \x01(\t\x12\x0e\n\x06is_add\x18\x03 \x01(\x08\"\x96\x01\n\x15KeepConnectedResponse\x12:\n\x0fvolume_location\x18\x01 \x01(\x0b\x32!.weedtpu_master_pb.VolumeLocation\x12\x41\n\x13\x63luster_node_update\x18\x02 \x01(\x0b\x32$.weedtpu_master_pb.ClusterNodeUpdate\"I\n\x11StatisticsRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x0b\n\x03ttl\x18\x03 \x01(\t\"O\n\x12StatisticsResponse\x12\x12\n\ntotal_size\x18\x01 \x01(\x04\x12\x11\n\tused_size\x18\x02 \x01(\x04\x12\x12\n\nfile_count\x18\x03 \x01(\x04\"\x17\n\x15\x43ollectionListRequest\"\x1a\n\nCollection\x12\x0c\n\x04name\x18\x01 \x01(\t\"L\n\x16\x43ollectionListResponse\x12\x32\n\x0b\x63ollections\x18\x01 \x03(\x0b\x32\x1d.weedtpu_master_pb.Collection\"\'\n\x17\x43ollectionDeleteRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"\x1a\n\x18\x43ollectionDeleteResponse\"\x1f\n\x1dGetMasterConfigurationRequest\"\xa1\x01\n\x1eGetMasterConfigurationResponse\x12\x17\n\x0fmetrics_address\x18\x01 \x01(\t\x12\x1d\n\x15volume_size_limit_m_b\x18\x02 \x01(\r\x12\x0e\n\x06leader\x18\x03 \x01(\t\x12\x1b\n\x13\x64\x65\x66\x61ult_replication\x18\x04 \x01(\t\x12\x1a\n\x12volume_preallocate\x18\x05 \x01(\r2\xa1\x07\n\x07Seaweed\x12Y\n\rSendHeartbeat\x12\x1c.weedtpu_master_pb.Heartbeat\x1a$.weedtpu_master_pb.HeartbeatResponse\"\x00(\x01\x30\x01\x12h\n\rKeepConnected\x12\'.weedtpu_master_pb.KeepConnectedRequest\x1a(.weedtpu_master_pb.KeepConnectedResponse\"\x00(\x01\x30\x01\x12O\n\x06\x41ssign\x12 .weedtpu_master_pb.AssignRequest\x1a!.weedtpu_master_pb.AssignResponse\"\x00\x12\x61\n\x0cLookupVolume\x12&.weedtpu_master_pb.LookupVolumeRequest\x1a\'.weedtpu_master_pb.LookupVolumeResponse\"\x00\x12g\n\x0eLookupEcVolume\x12(.weedtpu_master_pb.LookupEcVolumeRequest\x1a).weedtpu_master_pb.LookupEcVolumeResponse\"\x00\x12[\n\nStatistics\x12$.weedtpu_master_pb.StatisticsRequest\x1a%.weedtpu_master_pb.StatisticsResponse\"\x00\x12g\n\x0e\x43ollectionList\x12(.weedtpu_master_pb.CollectionListRequest\x1a).weedtpu_master_pb.CollectionListResponse\"\x00\x12m\n\x10\x43ollectionDelete\x12*.weedtpu_master_pb.CollectionDeleteRequest\x1a+.weedtpu_master_pb.CollectionDeleteResponse\"\x00\x12\x7f\n\x16GetMasterConfiguration\x12\x30.weedtpu_master_pb.GetMasterConfigurationRequest\x1a\x31.weedtpu_master_pb.GetMasterConfigurationResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'master_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HEARTBEAT._serialized_start=36
  _HEARTBEAT._serialized_end=619
  _HEARTBEATRESPONSE._serialized_start=621
  _HEARTBEATRESPONSE._serialized_end=733
  _VOLUMEINFORMATIONMESSAGE._serialized_start=736
  _VOLUMEINFORMATIONMESSAGE._serialized_end=954
  _VOLUMEECSHARDINFORMATIONMESSAGE._serialized_start=956
  _VOLUMEECSHARDINFORMATIONMESSAGE._serialized_end=1044
  _ASSIGNREQUEST._serialized_start=1046
  _ASSIGNREQUEST._serialized_end=1151
  _LOCATION._serialized_start=1153
  _LOCATION._serialized_end=1196
  _ASSIGNRESPONSE._serialized_start=1199
  _ASSIGNRESPONSE._serialized_end=1366
  _LOOKUPVOLUMEREQUEST._serialized_start=1368
  _LOOKUPVOLUMEREQUEST._serialized_end=1437
  _LOOKUPVOLUMERESPONSE._serialized_start=1440
  _LOOKUPVOLUMERESPONSE._serialized_end=1659
  _LOOKUPVOLUMERESPONSE_VOLUMEIDLOCATION._serialized_start=1551
  _LOOKUPVOLUMERESPONSE_VOLUMEIDLOCATION._serialized_end=1659
  _LOOKUPECVOLUMEREQUEST._serialized_start=1661
  _LOOKUPECVOLUMEREQUEST._serialized_end=1703
  _LOOKUPECVOLUMERESPONSE._serialized_start=1706
  _LOOKUPECVOLUMERESPONSE._serialized_end=1925
  _LOOKUPECVOLUMERESPONSE_ECSHARDIDLOCATION._serialized_start=1840
  _LOOKUPECVOLUMERESPONSE_ECSHARDIDLOCATION._serialized_end=1925
  _KEEPCONNECTEDREQUEST._serialized_start=1927
  _KEEPCONNECTEDREQUEST._serialized_end=2011
  _VOLUMELOCATION._serialized_start=2014
  _VOLUMELOCATION._serialized_end=2165
  _CLUSTERNODEUPDATE._serialized_start=2167
  _CLUSTERNODEUPDATE._serialized_end=2238
  _KEEPCONNECTEDRESPONSE._serialized_start=2241
  _KEEPCONNECTEDRESPONSE._serialized_end=2391
  _STATISTICSREQUEST._serialized_start=2393
  _STATISTICSREQUEST._serialized_end=2466
  _STATISTICSRESPONSE._serialized_start=2468
  _STATISTICSRESPONSE._serialized_end=2547
  _COLLECTIONLISTREQUEST._serialized_start=2549
  _COLLECTIONLISTREQUEST._serialized_end=2572
  _COLLECTION._serialized_start=2574
  _COLLECTION._serialized_end=2600
  _COLLECTIONLISTRESPONSE._serialized_start=2602
  _COLLECTIONLISTRESPONSE._serialized_end=2678
  _COLLECTIONDELETEREQUEST._serialized_start=2680
  _COLLECTIONDELETEREQUEST._serialized_end=2719
  _COLLECTIONDELETERESPONSE._serialized_start=2721
  _COLLECTIONDELETERESPONSE._serialized_end=2747
  _GETMASTERCONFIGURATIONREQUEST._serialized_start=2749
  _GETMASTERCONFIGURATIONREQUEST._serialized_end=2780
  _GETMASTERCONFIGURATIONRESPONSE._serialized_start=2783
  _GETMASTERCONFIGURATIONRESPONSE._serialized_end=2944
  _SEAWEED._serialized_start=2947
  _SEAWEED._serialized_end=3876
# @@protoc_insertion_point(module_scope)
