# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: volume_server.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13volume_server.proto\x12\x18weedtpu_volume_server_pb\"`\n\x15\x41llocateVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\"\x18\n\x16\x41llocateVolumeResponse\"(\n\x13VolumeDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\'\n\x14VolumeDeleteResponse\x12\x0f\n\x07\x64\x65leted\x18\x01 \x01(\x08\"A\n\x19VolumeMarkReadonlyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tread_only\x18\x02 \x01(\x08\"\x1c\n\x1aVolumeMarkReadonlyResponse\"\'\n\x12VolumeMountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x15\n\x13VolumeMountResponse\")\n\x14VolumeUnmountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x17\n\x15VolumeUnmountResponse\"@\n\x16VolumeConfigureRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x13\n\x0breplication\x18\x02 \x01(\t\"(\n\x17VolumeConfigureResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"-\n\x18VacuumVolumeCheckRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"2\n\x19VacuumVolumeCheckResponse\x12\x15\n\rgarbage_ratio\x18\x01 \x01(\x01\"/\n\x1aVacuumVolumeCompactRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"G\n\x1bVacuumVolumeCompactResponse\x12\x15\n\rgarbage_ratio\x18\x01 \x01(\x01\x12\x11\n\tcompacted\x18\x02 \x01(\x08\"&\n\x11VolumeSyncRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x14\n\x12VolumeSyncResponse\"T\n\x11VolumeCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x18\n\x10source_data_node\x18\x02 \x01(\t\x12\x12\n\ncollection\x18\x03 \x01(\t\"\x14\n\x12VolumeCopyResponse\"[\n\x0f\x43opyFileRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03\x65xt\x18\x03 \x01(\t\x12\x14\n\x0cis_ec_volume\x18\x04 \x01(\x08\"(\n\x10\x43opyFileResponse\x12\x14\n\x0c\x66ile_content\x18\x01 \x01(\x0c\"\x84\x01\n VolumeTierMoveDatToRemoteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12 \n\x18\x64\x65stination_backend_name\x18\x02 \x01(\t\x12\x0e\n\x06\x62ucket\x18\x03 \x01(\t\x12\x1b\n\x13keep_local_dat_file\x18\x04 \x01(\x08\"7\n!VolumeTierMoveDatToRemoteResponse\x12\x12\n\nremote_key\x18\x01 \x01(\t\"7\n\"VolumeTierMoveDatFromRemoteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"%\n#VolumeTierMoveDatFromRemoteResponse\"(\n\x13VolumeDigestRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\xa6\x01\n\x14VolumeDigestResponse\x12\x12\n\nfile_count\x18\x01 \x01(\x04\x12\x0e\n\x06\x64igest\x18\x02 \x01(\t\x12\x44\n\x04keys\x18\x03 \x03(\x0b\x32\x36.weedtpu_volume_server_pb.VolumeDigestResponse.KeySize\x1a$\n\x07KeySize\x12\x0b\n\x03key\x18\x01 \x01(\x04\x12\x0c\n\x04size\x18\x02 \x01(\x05\"=\n\x15ReadNeedleBlobRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\";\n\x16ReadNeedleBlobResponse\x12\x13\n\x0bneedle_blob\x18\x01 \x01(\x0c\x12\x0c\n\x04size\x18\x02 \x01(\x05\"a\n\x16WriteNeedleBlobRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\x12\x0c\n\x04size\x18\x03 \x01(\x05\x12\x13\n\x0bneedle_blob\x18\x04 \x01(\x0c\"\x19\n\x17WriteNeedleBlobResponse\"A\n\x12\x42\x61tchDeleteRequest\x12\x10\n\x08\x66ile_ids\x18\x01 \x03(\t\x12\x19\n\x11skip_cookie_check\x18\x02 \x01(\x08\"N\n\x13\x42\x61tchDeleteResponse\x12\x37\n\x07results\x18\x01 \x03(\x0b\x32&.weedtpu_volume_server_pb.DeleteResult\"L\n\x0c\x44\x65leteResult\x12\x0f\n\x07\x66ile_id\x18\x01 \x01(\t\x12\x0e\n\x06status\x18\x02 \x01(\x05\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12\x0c\n\x04size\x18\x04 \x01(\r\"\x1b\n\x19VolumeServerStatusRequest\"w\n\x1aVolumeServerStatusResponse\x12\x0f\n\x07version\x18\x01 \x01(\t\x12H\n\x07volumes\x18\x02 \x03(\x0b\x32\x37.weedtpu_volume_server_pb.VolumeShortInformationMessage\"t\n\x1dVolumeShortInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x12\n\nfile_count\x18\x03 \x01(\x04\x12\x0c\n\x04size\x18\x04 \x01(\x04\x12\x11\n\tread_only\x18\x05 \x01(\x08\"F\n\x1dVolumeEcShardsGenerateRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\".\n\x1eVolumeEcShardsGenerateResponse\x12\x0c\n\x04\x62\x61se\x18\x01 \x01(\t\"E\n\x1cVolumeEcShardsRebuildRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\":\n\x1dVolumeEcShardsRebuildResponse\x12\x19\n\x11rebuilt_shard_ids\x18\x01 \x03(\r\"\x86\x01\n\x19VolumeEcShardsCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\x12\x15\n\rcopy_ecx_file\x18\x04 \x01(\x08\x12\x18\n\x10source_data_node\x18\x05 \x01(\t\"\x1c\n\x1aVolumeEcShardsCopyResponse\"W\n\x1bVolumeEcShardsDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x1e\n\x1cVolumeEcShardsDeleteResponse\"V\n\x1aVolumeEcShardsMountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x1d\n\x1bVolumeEcShardsMountResponse\"D\n\x1cVolumeEcShardsUnmountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x1f\n\x1dVolumeEcShardsUnmountResponse\"o\n\x18VolumeEcShardReadRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08shard_id\x18\x02 \x01(\r\x12\x0e\n\x06offset\x18\x03 \x01(\x03\x12\x0c\n\x04size\x18\x04 \x01(\x03\x12\x10\n\x08\x66ile_key\x18\x05 \x01(\x04\"=\n\x19VolumeEcShardReadResponse\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x12\n\nis_deleted\x18\x02 \x01(\x08\"e\n\x19VolumeEcBlobDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x10\n\x08\x66ile_key\x18\x03 \x01(\x04\x12\x0f\n\x07version\x18\x04 \x01(\r\"\x1c\n\x1aVolumeEcBlobDeleteResponse\"F\n\x1dVolumeEcShardsToVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\" \n\x1eVolumeEcShardsToVolumeResponse\"C\n\x1cVolumeIncrementalCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\"5\n\x1dVolumeIncrementalCopyResponse\x12\x14\n\x0c\x66ile_content\x18\x01 \x01(\x0c\"\\\n\x17VolumeTailSenderRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\x12\x1c\n\x14idle_timeout_seconds\x18\x03 \x01(\r\"]\n\x18VolumeTailSenderResponse\x12\x15\n\rneedle_header\x18\x01 \x01(\x0c\x12\x13\n\x0bneedle_body\x18\x02 \x01(\x0c\x12\x15\n\ris_last_chunk\x18\x03 \x01(\x08\"|\n\x19VolumeTailReceiverRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\x12\x1c\n\x14idle_timeout_seconds\x18\x03 \x01(\r\x12\x1c\n\x14source_volume_server\x18\x04 \x01(\t\"\x1c\n\x1aVolumeTailReceiverResponse\"0\n\x1bReadVolumeFileStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x87\x02\n\x1cReadVolumeFileStatusResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\"\n\x1aidx_file_timestamp_seconds\x18\x02 \x01(\x04\x12\x15\n\ridx_file_size\x18\x03 \x01(\x04\x12\"\n\x1a\x64\x61t_file_timestamp_seconds\x18\x04 \x01(\x04\x12\x15\n\rdat_file_size\x18\x05 \x01(\x04\x12\x12\n\nfile_count\x18\x06 \x01(\x04\x12\x1b\n\x13\x63ompaction_revision\x18\x07 \x01(\r\x12\x12\n\ncollection\x18\x08 \x01(\t\x12\x19\n\x11last_append_at_ns\x18\t \x01(\x04\"A\n\x19VolumeNeedleStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\"~\n\x1aVolumeNeedleStatusResponse\x12\x11\n\tneedle_id\x18\x01 \x01(\x04\x12\x0e\n\x06\x63ookie\x18\x02 \x01(\r\x12\x0c\n\x04size\x18\x03 \x01(\r\x12\x15\n\rlast_modified\x18\x04 \x01(\x04\x12\x0b\n\x03\x63rc\x18\x05 \x01(\r\x12\x0b\n\x03ttl\x18\x06 \x01(\t\"2\n\x0bPingRequest\x12\x0e\n\x06target\x18\x01 \x01(\t\x12\x13\n\x0btarget_type\x18\x02 \x01(\t\"S\n\x0cPingResponse\x12\x15\n\rstart_time_ns\x18\x01 \x01(\x03\x12\x16\n\x0eremote_time_ns\x18\x02 \x01(\x03\x12\x14\n\x0cstop_time_ns\x18\x03 \x01(\x03\"\xb1\x01\n\x0cQueryRequest\x12\x12\n\nselections\x18\x01 \x03(\t\x12\x15\n\rfrom_file_ids\x18\x02 \x03(\t\x12=\n\x06\x66ilter\x18\x03 \x01(\x0b\x32-.weedtpu_volume_server_pb.QueryRequest.Filter\x1a\x37\n\x06\x46ilter\x12\r\n\x05\x66ield\x18\x01 \x01(\t\x12\x0f\n\x07operand\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\t\" \n\rQueriedStripe\x12\x0f\n\x07records\x18\x01 \x01(\x0c\x32\xd3!\n\x0cVolumeServer\x12u\n\x0e\x41llocateVolume\x12/.weedtpu_volume_server_pb.AllocateVolumeRequest\x1a\x30.weedtpu_volume_server_pb.AllocateVolumeResponse\"\x00\x12o\n\x0cVolumeDelete\x12-.weedtpu_volume_server_pb.VolumeDeleteRequest\x1a..weedtpu_volume_server_pb.VolumeDeleteResponse\"\x00\x12\x81\x01\n\x12VolumeMarkReadonly\x12\x33.weedtpu_volume_server_pb.VolumeMarkReadonlyRequest\x1a\x34.weedtpu_volume_server_pb.VolumeMarkReadonlyResponse\"\x00\x12l\n\x0bVolumeMount\x12,.weedtpu_volume_server_pb.VolumeMountRequest\x1a-.weedtpu_volume_server_pb.VolumeMountResponse\"\x00\x12r\n\rVolumeUnmount\x12..weedtpu_volume_server_pb.VolumeUnmountRequest\x1a/.weedtpu_volume_server_pb.VolumeUnmountResponse\"\x00\x12x\n\x0fVolumeConfigure\x12\x30.weedtpu_volume_server_pb.VolumeConfigureRequest\x1a\x31.weedtpu_volume_server_pb.VolumeConfigureResponse\"\x00\x12~\n\x11VacuumVolumeCheck\x12\x32.weedtpu_volume_server_pb.VacuumVolumeCheckRequest\x1a\x33.weedtpu_volume_server_pb.VacuumVolumeCheckResponse\"\x00\x12\x84\x01\n\x13VacuumVolumeCompact\x12\x34.weedtpu_volume_server_pb.VacuumVolumeCompactRequest\x1a\x35.weedtpu_volume_server_pb.VacuumVolumeCompactResponse\"\x00\x12i\n\nVolumeSync\x12+.weedtpu_volume_server_pb.VolumeSyncRequest\x1a,.weedtpu_volume_server_pb.VolumeSyncResponse\"\x00\x12i\n\nVolumeCopy\x12+.weedtpu_volume_server_pb.VolumeCopyRequest\x1a,.weedtpu_volume_server_pb.VolumeCopyResponse\"\x00\x12\x65\n\x08\x43opyFile\x12).weedtpu_volume_server_pb.CopyFileRequest\x1a*.weedtpu_volume_server_pb.CopyFileResponse\"\x00\x30\x01\x12\x96\x01\n\x19VolumeTierMoveDatToRemote\x12:.weedtpu_volume_server_pb.VolumeTierMoveDatToRemoteRequest\x1a;.weedtpu_volume_server_pb.VolumeTierMoveDatToRemoteResponse\"\x00\x12\x9c\x01\n\x1bVolumeTierMoveDatFromRemote\x12<.weedtpu_volume_server_pb.VolumeTierMoveDatFromRemoteRequest\x1a=.weedtpu_volume_server_pb.VolumeTierMoveDatFromRemoteResponse\"\x00\x12o\n\x0cVolumeDigest\x12-.weedtpu_volume_server_pb.VolumeDigestRequest\x1a..weedtpu_volume_server_pb.VolumeDigestResponse\"\x00\x12u\n\x0eReadNeedleBlob\x12/.weedtpu_volume_server_pb.ReadNeedleBlobRequest\x1a\x30.weedtpu_volume_server_pb.ReadNeedleBlobResponse\"\x00\x12x\n\x0fWriteNeedleBlob\x12\x30.weedtpu_volume_server_pb.WriteNeedleBlobRequest\x1a\x31.weedtpu_volume_server_pb.WriteNeedleBlobResponse\"\x00\x12l\n\x0b\x42\x61tchDelete\x12,.weedtpu_volume_server_pb.BatchDeleteRequest\x1a-.weedtpu_volume_server_pb.BatchDeleteResponse\"\x00\x12\x81\x01\n\x12VolumeServerStatus\x12\x33.weedtpu_volume_server_pb.VolumeServerStatusRequest\x1a\x34.weedtpu_volume_server_pb.VolumeServerStatusResponse\"\x00\x12\x8c\x01\n\x15VolumeIncrementalCopy\x12\x36.weedtpu_volume_server_pb.VolumeIncrementalCopyRequest\x1a\x37.weedtpu_volume_server_pb.VolumeIncrementalCopyResponse\"\x00\x30\x01\x12}\n\x10VolumeTailSender\x12\x31.weedtpu_volume_server_pb.VolumeTailSenderRequest\x1a\x32.weedtpu_volume_server_pb.VolumeTailSenderResponse\"\x00\x30\x01\x12\x81\x01\n\x12VolumeTailReceiver\x12\x33.weedtpu_volume_server_pb.VolumeTailReceiverRequest\x1a\x34.weedtpu_volume_server_pb.VolumeTailReceiverResponse\"\x00\x12\x87\x01\n\x14ReadVolumeFileStatus\x12\x35.weedtpu_volume_server_pb.ReadVolumeFileStatusRequest\x1a\x36.weedtpu_volume_server_pb.ReadVolumeFileStatusResponse\"\x00\x12\x81\x01\n\x12VolumeNeedleStatus\x12\x33.weedtpu_volume_server_pb.VolumeNeedleStatusRequest\x1a\x34.weedtpu_volume_server_pb.VolumeNeedleStatusResponse\"\x00\x12W\n\x04Ping\x12%.weedtpu_volume_server_pb.PingRequest\x1a&.weedtpu_volume_server_pb.PingResponse\"\x00\x12\\\n\x05Query\x12&.weedtpu_volume_server_pb.QueryRequest\x1a\'.weedtpu_volume_server_pb.QueriedStripe\"\x00\x30\x01\x12\x8d\x01\n\x16VolumeEcShardsGenerate\x12\x37.weedtpu_volume_server_pb.VolumeEcShardsGenerateRequest\x1a\x38.weedtpu_volume_server_pb.VolumeEcShardsGenerateResponse\"\x00\x12\x8a\x01\n\x15VolumeEcShardsRebuild\x12\x36.weedtpu_volume_server_pb.VolumeEcShardsRebuildRequest\x1a\x37.weedtpu_volume_server_pb.VolumeEcShardsRebuildResponse\"\x00\x12\x81\x01\n\x12VolumeEcShardsCopy\x12\x33.weedtpu_volume_server_pb.VolumeEcShardsCopyRequest\x1a\x34.weedtpu_volume_server_pb.VolumeEcShardsCopyResponse\"\x00\x12\x87\x01\n\x14VolumeEcShardsDelete\x12\x35.weedtpu_volume_server_pb.VolumeEcShardsDeleteRequest\x1a\x36.weedtpu_volume_server_pb.VolumeEcShardsDeleteResponse\"\x00\x12\x84\x01\n\x13VolumeEcShardsMount\x12\x34.weedtpu_volume_server_pb.VolumeEcShardsMountRequest\x1a\x35.weedtpu_volume_server_pb.VolumeEcShardsMountResponse\"\x00\x12\x8a\x01\n\x15VolumeEcShardsUnmount\x12\x36.weedtpu_volume_server_pb.VolumeEcShardsUnmountRequest\x1a\x37.weedtpu_volume_server_pb.VolumeEcShardsUnmountResponse\"\x00\x12\x80\x01\n\x11VolumeEcShardRead\x12\x32.weedtpu_volume_server_pb.VolumeEcShardReadRequest\x1a\x33.weedtpu_volume_server_pb.VolumeEcShardReadResponse\"\x00\x30\x01\x12\x81\x01\n\x12VolumeEcBlobDelete\x12\x33.weedtpu_volume_server_pb.VolumeEcBlobDeleteRequest\x1a\x34.weedtpu_volume_server_pb.VolumeEcBlobDeleteResponse\"\x00\x12\x8d\x01\n\x16VolumeEcShardsToVolume\x12\x37.weedtpu_volume_server_pb.VolumeEcShardsToVolumeRequest\x1a\x38.weedtpu_volume_server_pb.VolumeEcShardsToVolumeResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'volume_server_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ALLOCATEVOLUMEREQUEST._serialized_start=49
  _ALLOCATEVOLUMEREQUEST._serialized_end=145
  _ALLOCATEVOLUMERESPONSE._serialized_start=147
  _ALLOCATEVOLUMERESPONSE._serialized_end=171
  _VOLUMEDELETEREQUEST._serialized_start=173
  _VOLUMEDELETEREQUEST._serialized_end=213
  _VOLUMEDELETERESPONSE._serialized_start=215
  _VOLUMEDELETERESPONSE._serialized_end=254
  _VOLUMEMARKREADONLYREQUEST._serialized_start=256
  _VOLUMEMARKREADONLYREQUEST._serialized_end=321
  _VOLUMEMARKREADONLYRESPONSE._serialized_start=323
  _VOLUMEMARKREADONLYRESPONSE._serialized_end=351
  _VOLUMEMOUNTREQUEST._serialized_start=353
  _VOLUMEMOUNTREQUEST._serialized_end=392
  _VOLUMEMOUNTRESPONSE._serialized_start=394
  _VOLUMEMOUNTRESPONSE._serialized_end=415
  _VOLUMEUNMOUNTREQUEST._serialized_start=417
  _VOLUMEUNMOUNTREQUEST._serialized_end=458
  _VOLUMEUNMOUNTRESPONSE._serialized_start=460
  _VOLUMEUNMOUNTRESPONSE._serialized_end=483
  _VOLUMECONFIGUREREQUEST._serialized_start=485
  _VOLUMECONFIGUREREQUEST._serialized_end=549
  _VOLUMECONFIGURERESPONSE._serialized_start=551
  _VOLUMECONFIGURERESPONSE._serialized_end=591
  _VACUUMVOLUMECHECKREQUEST._serialized_start=593
  _VACUUMVOLUMECHECKREQUEST._serialized_end=638
  _VACUUMVOLUMECHECKRESPONSE._serialized_start=640
  _VACUUMVOLUMECHECKRESPONSE._serialized_end=690
  _VACUUMVOLUMECOMPACTREQUEST._serialized_start=692
  _VACUUMVOLUMECOMPACTREQUEST._serialized_end=739
  _VACUUMVOLUMECOMPACTRESPONSE._serialized_start=741
  _VACUUMVOLUMECOMPACTRESPONSE._serialized_end=812
  _VOLUMESYNCREQUEST._serialized_start=814
  _VOLUMESYNCREQUEST._serialized_end=852
  _VOLUMESYNCRESPONSE._serialized_start=854
  _VOLUMESYNCRESPONSE._serialized_end=874
  _VOLUMECOPYREQUEST._serialized_start=876
  _VOLUMECOPYREQUEST._serialized_end=960
  _VOLUMECOPYRESPONSE._serialized_start=962
  _VOLUMECOPYRESPONSE._serialized_end=982
  _COPYFILEREQUEST._serialized_start=984
  _COPYFILEREQUEST._serialized_end=1075
  _COPYFILERESPONSE._serialized_start=1077
  _COPYFILERESPONSE._serialized_end=1117
  _VOLUMETIERMOVEDATTOREMOTEREQUEST._serialized_start=1120
  _VOLUMETIERMOVEDATTOREMOTEREQUEST._serialized_end=1252
  _VOLUMETIERMOVEDATTOREMOTERESPONSE._serialized_start=1254
  _VOLUMETIERMOVEDATTOREMOTERESPONSE._serialized_end=1309
  _VOLUMETIERMOVEDATFROMREMOTEREQUEST._serialized_start=1311
  _VOLUMETIERMOVEDATFROMREMOTEREQUEST._serialized_end=1366
  _VOLUMETIERMOVEDATFROMREMOTERESPONSE._serialized_start=1368
  _VOLUMETIERMOVEDATFROMREMOTERESPONSE._serialized_end=1405
  _VOLUMEDIGESTREQUEST._serialized_start=1407
  _VOLUMEDIGESTREQUEST._serialized_end=1447
  _VOLUMEDIGESTRESPONSE._serialized_start=1450
  _VOLUMEDIGESTRESPONSE._serialized_end=1616
  _VOLUMEDIGESTRESPONSE_KEYSIZE._serialized_start=1580
  _VOLUMEDIGESTRESPONSE_KEYSIZE._serialized_end=1616
  _READNEEDLEBLOBREQUEST._serialized_start=1618
  _READNEEDLEBLOBREQUEST._serialized_end=1679
  _READNEEDLEBLOBRESPONSE._serialized_start=1681
  _READNEEDLEBLOBRESPONSE._serialized_end=1740
  _WRITENEEDLEBLOBREQUEST._serialized_start=1742
  _WRITENEEDLEBLOBREQUEST._serialized_end=1839
  _WRITENEEDLEBLOBRESPONSE._serialized_start=1841
  _WRITENEEDLEBLOBRESPONSE._serialized_end=1866
  _BATCHDELETEREQUEST._serialized_start=1868
  _BATCHDELETEREQUEST._serialized_end=1933
  _BATCHDELETERESPONSE._serialized_start=1935
  _BATCHDELETERESPONSE._serialized_end=2013
  _DELETERESULT._serialized_start=2015
  _DELETERESULT._serialized_end=2091
  _VOLUMESERVERSTATUSREQUEST._serialized_start=2093
  _VOLUMESERVERSTATUSREQUEST._serialized_end=2120
  _VOLUMESERVERSTATUSRESPONSE._serialized_start=2122
  _VOLUMESERVERSTATUSRESPONSE._serialized_end=2241
  _VOLUMESHORTINFORMATIONMESSAGE._serialized_start=2243
  _VOLUMESHORTINFORMATIONMESSAGE._serialized_end=2359
  _VOLUMEECSHARDSGENERATEREQUEST._serialized_start=2361
  _VOLUMEECSHARDSGENERATEREQUEST._serialized_end=2431
  _VOLUMEECSHARDSGENERATERESPONSE._serialized_start=2433
  _VOLUMEECSHARDSGENERATERESPONSE._serialized_end=2479
  _VOLUMEECSHARDSREBUILDREQUEST._serialized_start=2481
  _VOLUMEECSHARDSREBUILDREQUEST._serialized_end=2550
  _VOLUMEECSHARDSREBUILDRESPONSE._serialized_start=2552
  _VOLUMEECSHARDSREBUILDRESPONSE._serialized_end=2610
  _VOLUMEECSHARDSCOPYREQUEST._serialized_start=2613
  _VOLUMEECSHARDSCOPYREQUEST._serialized_end=2747
  _VOLUMEECSHARDSCOPYRESPONSE._serialized_start=2749
  _VOLUMEECSHARDSCOPYRESPONSE._serialized_end=2777
  _VOLUMEECSHARDSDELETEREQUEST._serialized_start=2779
  _VOLUMEECSHARDSDELETEREQUEST._serialized_end=2866
  _VOLUMEECSHARDSDELETERESPONSE._serialized_start=2868
  _VOLUMEECSHARDSDELETERESPONSE._serialized_end=2898
  _VOLUMEECSHARDSMOUNTREQUEST._serialized_start=2900
  _VOLUMEECSHARDSMOUNTREQUEST._serialized_end=2986
  _VOLUMEECSHARDSMOUNTRESPONSE._serialized_start=2988
  _VOLUMEECSHARDSMOUNTRESPONSE._serialized_end=3017
  _VOLUMEECSHARDSUNMOUNTREQUEST._serialized_start=3019
  _VOLUMEECSHARDSUNMOUNTREQUEST._serialized_end=3087
  _VOLUMEECSHARDSUNMOUNTRESPONSE._serialized_start=3089
  _VOLUMEECSHARDSUNMOUNTRESPONSE._serialized_end=3120
  _VOLUMEECSHARDREADREQUEST._serialized_start=3122
  _VOLUMEECSHARDREADREQUEST._serialized_end=3233
  _VOLUMEECSHARDREADRESPONSE._serialized_start=3235
  _VOLUMEECSHARDREADRESPONSE._serialized_end=3296
  _VOLUMEECBLOBDELETEREQUEST._serialized_start=3298
  _VOLUMEECBLOBDELETEREQUEST._serialized_end=3399
  _VOLUMEECBLOBDELETERESPONSE._serialized_start=3401
  _VOLUMEECBLOBDELETERESPONSE._serialized_end=3429
  _VOLUMEECSHARDSTOVOLUMEREQUEST._serialized_start=3431
  _VOLUMEECSHARDSTOVOLUMEREQUEST._serialized_end=3501
  _VOLUMEECSHARDSTOVOLUMERESPONSE._serialized_start=3503
  _VOLUMEECSHARDSTOVOLUMERESPONSE._serialized_end=3535
  _VOLUMEINCREMENTALCOPYREQUEST._serialized_start=3537
  _VOLUMEINCREMENTALCOPYREQUEST._serialized_end=3604
  _VOLUMEINCREMENTALCOPYRESPONSE._serialized_start=3606
  _VOLUMEINCREMENTALCOPYRESPONSE._serialized_end=3659
  _VOLUMETAILSENDERREQUEST._serialized_start=3661
  _VOLUMETAILSENDERREQUEST._serialized_end=3753
  _VOLUMETAILSENDERRESPONSE._serialized_start=3755
  _VOLUMETAILSENDERRESPONSE._serialized_end=3848
  _VOLUMETAILRECEIVERREQUEST._serialized_start=3850
  _VOLUMETAILRECEIVERREQUEST._serialized_end=3974
  _VOLUMETAILRECEIVERRESPONSE._serialized_start=3976
  _VOLUMETAILRECEIVERRESPONSE._serialized_end=4004
  _READVOLUMEFILESTATUSREQUEST._serialized_start=4006
  _READVOLUMEFILESTATUSREQUEST._serialized_end=4054
  _READVOLUMEFILESTATUSRESPONSE._serialized_start=4057
  _READVOLUMEFILESTATUSRESPONSE._serialized_end=4320
  _VOLUMENEEDLESTATUSREQUEST._serialized_start=4322
  _VOLUMENEEDLESTATUSREQUEST._serialized_end=4387
  _VOLUMENEEDLESTATUSRESPONSE._serialized_start=4389
  _VOLUMENEEDLESTATUSRESPONSE._serialized_end=4515
  _PINGREQUEST._serialized_start=4517
  _PINGREQUEST._serialized_end=4567
  _PINGRESPONSE._serialized_start=4569
  _PINGRESPONSE._serialized_end=4652
  _QUERYREQUEST._serialized_start=4655
  _QUERYREQUEST._serialized_end=4832
  _QUERYREQUEST_FILTER._serialized_start=4777
  _QUERYREQUEST_FILTER._serialized_end=4832
  _QUERIEDSTRIPE._serialized_start=4834
  _QUERIEDSTRIPE._serialized_end=4866
  _VOLUMESERVER._serialized_start=4869
  _VOLUMESERVER._serialized_end=9176
# @@protoc_insertion_point(module_scope)
